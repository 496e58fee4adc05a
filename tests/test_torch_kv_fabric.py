"""The port's KV fabric and binary data plane (``paddle_tpu_torch``'s
``inference/blockwire.py``, ``inference/kv_fabric.py`` and
``ServingEngine.pull_blocks``) against the reference's, on 127.0.0.1.

* Framing: a frame round-trips over a socket pair, and a torn frame (bad
  magic), a bad CRC, a truncated stream and a header that overruns its
  buffer raise ``WireError``; ``pack_blocks`` gives the reference's bytes.
* ``pull_blocks`` in every direction between the packages: port <- port,
  port <- a ``BlockWireServer`` over the JAX engine, and JAX <- port.
  The importer holds the chain (prefix hits on every block) and serves
  the prompt with the tokens of a locally warmed run.
* A fenced handshake: a puller below the listener's epoch gets
  ``StaleEpoch`` before any payload byte moves.
* A disaggregated frontend (a prefill-role and a decode-role replica, a
  listener on the prefill one, ``KVFabric`` over ``MemoryKV``) gives the
  reference frontend's tokens, greedy and seeded, with every pull over
  the wire: no fallback, relay, failure or recompute; its fabric counters
  and the frontend's equal the reference's.
"""
import socket
import struct
import zlib

import pytest
import torch

from test_torch_control_plane import make_sides

torch.set_num_threads(2)

ENGINE = dict(max_batch_size=2, max_seq_len=96, block_size=8,
              num_blocks=48)
PROMPT = list(range(2, 34))          # 4 full blocks at block size 8
PROMPT_B = [(11 * i + 5) % 250 + 1 for i in range(27)]
SEEDED = dict(temperature=0.8, top_p=0.9, seed=7)


@pytest.fixture(scope="module")
def sides(serving_model):
    return make_sides(serving_model)


def _engine(side, role=None, **kw):
    eng = side.engine(**{**ENGINE, **kw})
    if role is not None:
        eng.role = role
    return eng


def _serve(side, fe, prompt, n, **kw):
    rid = fe.submit(prompt, max_new_tokens=n, **kw)
    res = fe.run()[rid]
    assert res.status is side.RequestStatus.COMPLETED, res
    return [int(t) for t in res.tokens]


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


def test_framing_and_typed_wire_errors(sides):
    jax_side, port = sides
    bw = port.blockwire
    a, b = _pair()
    bw.send_frame(a, b"J" + b'{"op":"x"}')
    assert bw.recv_frame(b) == b"J" + b'{"op":"x"}'
    a.sendall(b"XXXX" + struct.pack(">II", 4, 0) + b"torn")
    with pytest.raises(bw.WireError, match="magic"):
        bw.recv_frame(b)
    a, b = _pair()
    payload = b"Jgarbled-in-flight"
    a.sendall(bw.MAGIC + struct.pack(">II", len(payload),
                                     zlib.crc32(payload) ^ 0xFF) + payload)
    with pytest.raises(bw.WireError, match="CRC"):
        bw.recv_frame(b)
    a, b = _pair()
    payload = b"B" + b"\0" * 64
    frame = bw.MAGIC + struct.pack(">II", len(payload),
                                   zlib.crc32(payload)) + payload
    a.sendall(frame[:len(frame) // 2])
    a.close()
    with pytest.raises(bw.WireError, match="truncated"):
        bw.recv_frame(b)
    with pytest.raises(bw.WireError, match="overruns"):
        bw.unpack_blocks(b"B" + struct.pack(">I", 1 << 20) + b"{}")
    header, raw = {"shape": [1, 2], "dtype": "float32"}, b"\x01\x02"
    packed = bw.pack_blocks(header, raw)
    assert packed == jax_side.blockwire.pack_blocks(header, raw)
    assert bw.unpack_blocks(packed) == (header, raw)
    # a frame the reference sends, the port reads
    a, b = _pair()
    jax_side.blockwire.send_frame(a, packed)
    assert bw.recv_frame(b) == packed


def _warmed(side):
    """An engine that computed PROMPT's chain, and the chain's hashes."""
    eng = _engine(side)
    _serve(side, side.ServingFrontend(eng), PROMPT, 2)
    return eng, side.serving.prompt_block_hashes(PROMPT, ENGINE["block_size"])


@pytest.mark.parametrize("src,dst", [("port", "port"), ("jax", "port"),
                                     ("port", "jax")])
def test_pull_blocks_across_packages(sides, src, dst):
    """The destination engine pulls the warm chain off the source's
    listener: all blocks imported, the bytes the source's packed export
    holds, prefix hits on every block, and the tokens (greedy and
    seeded) of the destination package's own warmed run."""
    by = {s.name: s for s in sides}
    s_side, d_side = by[src], by[dst]
    a, hashes = _warmed(s_side)
    header, raw = a.export_blocks_packed(hashes)
    with s_side.blockwire.BlockWireServer(a) as srv:
        b = _engine(d_side)
        assert b.pull_blocks(srv.endpoint, hashes) == (len(hashes),
                                                      len(raw))
        assert srv.counters["serve_pulls_total"] == 1
        assert srv.counters["serve_bytes_total"] == len(raw)
    assert a.wire_endpoint is None
    assert b.export_blocks_packed(hashes) == (header, raw)
    got = _serve(d_side, d_side.ServingFrontend(b), PROMPT, 8)
    assert b.prefix_hit_blocks == len(hashes)
    local, _ = _warmed(d_side)
    assert _serve(d_side, d_side.ServingFrontend(local), PROMPT, 8) == got
    seeded = [_serve(s, s.ServingFrontend(e), PROMPT, 8, **SEEDED)
              for s, e in ((d_side, b), (d_side, _warmed(d_side)[0]))]
    assert seeded[0] == seeded[1]


def test_fenced_handshake_moves_no_bytes(sides):
    port = sides[1]
    a, hashes = _warmed(port)
    fence = port.ha.EpochFence()
    fence.check(2, "test")
    with port.blockwire.BlockWireServer(a, fence=fence) as srv:
        b = _engine(port)
        with pytest.raises(port.ha.StaleEpoch):
            b.pull_blocks(srv.endpoint, hashes, epoch=1)
        assert srv.counters["serve_fenced_total"] == 1
        assert srv.counters["serve_pulls_total"] == 0
        assert srv.counters["serve_bytes_total"] == 0
        assert not b.cached_block_hashes()
        n, _ = b.pull_blocks(srv.endpoint, hashes, epoch=2)
        assert n == len(hashes)


def _disaggregated(side):
    """Greedy and seeded requests through a prefill-role and a decode-role
    replica with a listener on the prefill one: (tokens, fabric counters,
    frontend fabric counters, colocated tokens)."""
    colocated = [_serve(side, side.ServingFrontend(_engine(side)), p, 8,
                        **kw) for p, kw in ((PROMPT, {}),
                                            (PROMPT_B, SEEDED))]
    fab = side.kv_fabric.KVFabric(side.kv_fabric.MemoryKV())
    pre = _engine(side, "prefill")
    with side.blockwire.BlockWireServer(pre):
        fe = side.ServingFrontend([pre, _engine(side, "decode")],
                                  kv_fabric=fab)
        got = [_serve(side, fe, p, 8, **kw)
               for p, kw in ((PROMPT, {}), (PROMPT_B, SEEDED))]
    fe_counters = {k: v for k, v in fe.metrics.snapshot()["counters"].items()
                   if k.startswith("fabric_")}
    return got, dict(fab.counters), fe_counters, colocated


def test_disaggregated_frontend_over_the_wire(sides):
    ref, port = (_disaggregated(s) for s in sides)
    assert port == ref
    got, fab, fe, colocated = port
    assert got == colocated
    assert fab["wire_pulls_total"] >= 1
    assert fab["wire_bytes_total"] == fab["pulled_bytes_total"] > 0
    for k in ("wire_fallbacks_total", "relay_pulls_total",
              "relay_bytes_total"):
        assert fab[k] == 0, k
    assert fe["fabric_wire_pulls_total"] >= 1
    for k in ("fabric_relay_pulls_total", "fabric_pull_failures_total",
              "fabric_recomputes_total"):
        assert fe.get(k, 0) == 0, k
