"""KV block export and import in the port's ServingEngine against the JAX
engine.

Both engines serve the same prompts from the same weights on the CPU, then
move published blocks between them.  Asserted: the port's headers equal
the JAX engine's key by key; the JAX packed export imported into the port
and exported again gives the same bytes, and the reverse; each engine then
serves the prompt on the imported blocks with as many prefix-hit blocks as
it imported and with the tokens of its own locally warmed run; the JAX
dict form (bfloat16 as ``ml_dtypes`` arrays) imports into a bfloat16 port
engine; every malformed payload raises a ValueError with the pool and the
cache bytes unchanged; and the stop at a chain's first gap, the stop and
the evictions under allocation pressure and the skip of cached hashes
match the JAX engine's.  Bytes are compared exactly: a transfer moves bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu_torch.inference.serving import ServingEngine as PortEngine
from paddle_tpu_torch.inference.serving import prompt_block_hashes
from test_torch_serving import _port_from

torch.set_num_threads(2)

ENGINE = dict(max_batch_size=2, max_seq_len=64, block_size=8,
              token_budget=16, megastep_k=4)
PROMPT = [(7 * i + 3) % 251 + 1 for i in range(27)]     # 3 full blocks
HASHES = prompt_block_hashes(PROMPT, 8)


@pytest.fixture(scope="module")
def mha(serving_model):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    return serving_model, _port_from(serving_model)


def _jax(pair, **kw):
    return JaxEngine(pair[0], **{**ENGINE, **kw})


def _port(pair, **kw):
    return PortEngine(pair[1], device="cpu", **{**ENGINE, **kw})


def _warm(eng, prompt=PROMPT, n=6):
    rid = eng.add_request(prompt, max_new_tokens=n)
    return eng.run()[rid]


def _state(eng):
    """The pool's host state and (for the port) the cache bytes."""
    b = eng.blocks
    state = (list(b._free), dict(b._ref), dict(b._hash_of),
             list(b._lru), b.evictions)
    if isinstance(eng, PortEngine):
        state += ([c.clone() for c in eng.key_caches + eng.value_caches],)
    return state


def _same_state(a, b):
    assert a[:5] == b[:5]
    if len(a) > 5:
        assert all(torch.equal(x, y) for x, y in zip(a[5], b[5]))


def test_header_equals_the_reference(mha):
    jeng, peng = _jax(mha), _port(mha)
    _warm(jeng)
    _warm(peng)
    jh, jraw = jeng.export_blocks_packed(HASHES)
    ph, praw = peng.export_blocks_packed(HASHES)
    assert ph == jh
    assert ph["dtype"] == "float32" and ph["hashes"] == HASHES
    assert len(praw) == len(jraw) == int(np.prod(ph["shape"])) * 4
    jd, pd = jeng.export_blocks(HASHES), peng.export_blocks(HASHES)
    assert {k: v for k, v in pd.items() if k != "blocks"} == \
        {k: v for k, v in jd.items() if k != "blocks"}
    assert list(pd["blocks"]) == list(jd["blocks"]) == HASHES
    arr = np.frombuffer(praw, np.float32).reshape(ph["shape"])
    for i, h in enumerate(HASHES):
        for li in range(ph["layers"]):
            k = pd["blocks"][h]["k"][li]
            assert isinstance(k, torch.Tensor) and k.device.type == "cpu"
            np.testing.assert_array_equal(k.numpy(), arr[0, li, i])
            np.testing.assert_array_equal(pd["blocks"][h]["v"][li].numpy(),
                                          arr[1, li, i])
    assert peng.export_blocks_packed([]) == (
        {**ph, "hashes": [], "shape": [2, ph["layers"], 0] + ph["shape"][3:]},
        b"")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_packed_round_trip_and_prefix_hits(mha, direction):
    """Export from one package, import into a fresh engine of the other,
    export again: the same bytes.  The importer then serves the prompt on
    the imported blocks: prefix hits equal to the imported count, and its
    own locally warmed run's tokens."""
    src, dst = ((_jax(mha), _port(mha)) if direction == "jax_to_port"
                else (_port(mha), _jax(mha)))
    _warm(src)
    header, raw = src.export_blocks_packed(HASHES)
    assert dst.import_blocks_packed(header, raw) == len(HASHES)
    assert dst.cached_block_hashes() == set(HASHES)
    assert dst.export_blocks_packed(HASHES) == (header, raw)
    got = _warm(dst, n=8)
    assert dst.prefix_hit_blocks == len(HASHES)
    assert dst.prefill_tokens_computed == len(PROMPT) - 8 * len(HASHES)
    local = _jax(mha) if direction == "port_to_jax" else _port(mha)
    _warm(local)
    assert _warm(local, n=8) == got
    assert local.prefix_hit_blocks == len(HASHES)


def test_reference_dict_form_in_bfloat16(mha):
    """The JAX dict form of a bfloat16 cache holds ``ml_dtypes`` arrays;
    a bfloat16 port engine imports it (16-bit integer views, no
    ``ml_dtypes`` import in the port) and exports the same bytes, then
    serves on it as on its own warm blocks."""
    jeng = _jax(mha, cache_dtype=jnp.bfloat16)
    peng = _port(mha, cache_dtype="bfloat16")
    _warm(jeng)
    payload = jeng.export_blocks(HASHES)
    assert payload["dtype"] == "bfloat16"
    assert payload["blocks"][HASHES[0]]["k"][0].dtype.name == "bfloat16"
    assert peng.import_blocks(payload) == len(HASHES)
    assert peng.export_blocks_packed(HASHES) == \
        jeng.export_blocks_packed(HASHES)
    back = peng.export_blocks(HASHES)
    assert back["blocks"][HASHES[1]]["v"][0].dtype == torch.bfloat16
    got = _warm(peng, n=8)
    assert peng.prefix_hit_blocks == len(HASHES)
    local = _port(mha, cache_dtype="bfloat16")
    _warm(local)
    assert _warm(local, n=8) == got
    # and the port's own dict form back into a fresh port engine
    again = _port(mha, cache_dtype="bfloat16")
    assert again.import_blocks(back) == len(HASHES)
    assert again.export_blocks_packed(HASHES) == \
        peng.export_blocks_packed(HASHES)


def _bad_packed(header, raw):
    """(the error's words, header, raw): malformed copies of a packed
    payload."""
    shape = header["shape"]
    return [
        ("geometry", {**header, "block_size": 16}, raw),
        ("geometry", {**header, "layers": header["layers"] + 1}, raw),
        ("geometry", {**header, "dtype": "bfloat16"}, raw),
        ("header shape", {**header, "shape": shape[:5] + [shape[5] // 2]},
         raw),
        ("header shape", {**header, "hashes": header["hashes"][:-1]}, raw),
        ("truncated", header, raw[:-4]),
        ("truncated or padded", header, raw + b"\0" * 4),
    ]


def test_malformed_payloads_raise_and_change_nothing(mha):
    src = _port(mha)
    _warm(src)
    header, raw = src.export_blocks_packed(HASHES)
    payload = src.export_blocks(HASHES)
    eng = _port(mha)
    _warm(eng, [5, 6, 7] * 6)               # a pool that holds something
    before = _state(eng)
    for what, h, r in _bad_packed(header, raw):
        with pytest.raises(ValueError, match=what):
            eng.import_blocks_packed(h, r)
        _same_state(_state(eng), before)
    h0 = HASHES[0]
    block = payload["blocks"][h0]
    bad_dicts = [
        ("geometry", {**payload, "head_dim": 16}),
        ("geometry", {**payload, "dtype": "float16"}),
        ("layers", {**payload, "blocks": {h0: {
            "k": block["k"] * 2, "v": block["v"]}}}),
        ("dtype", {**payload, "blocks": {h0: {
            "k": [k.double() for k in block["k"]], "v": block["v"]}}}),
        ("shape", {**payload, "blocks": {h0: {
            "k": [k[:, :4] for k in block["k"]], "v": block["v"]}}}),
        ("dtype", {**payload, "blocks": {h0: {
            "k": block["k"], "v": [v.numpy().astype(np.float16)
                                   for v in block["v"]]}}}),
        ("not a tensor or an array", {**payload, "blocks": {h0: {
            "k": block["k"], "v": [v.tolist() for v in block["v"]]}}}),
        # a good first block, then a bad one: nothing is imported
        ("layers", {**payload, "blocks": {
            h0: block, HASHES[1]: {"k": block["k"], "v": []}}}),
    ]
    for what, p in bad_dicts:
        with pytest.raises(ValueError, match=what):
            eng.import_blocks(p)
        _same_state(_state(eng), before)
    # the JAX engine refuses the same packed payloads
    jeng = _jax(mha)
    for what, h, r in _bad_packed(header, raw):
        with pytest.raises(ValueError):
            jeng.import_blocks_packed(h, r)


def test_chain_gap_pressure_and_cached_hashes(mha):
    """As the reference: an export stops at the chain's first gap; an
    import skips hashes already cached, evicts the oldest cached blocks
    (its own included) when the free list is empty, and stops when every
    block is live."""
    jsrc, psrc = _jax(mha), _port(mha)
    _warm(jsrc)
    _warm(psrc)
    gap = [HASHES[0], "missing", HASHES[1]]
    jh, _ = jsrc.export_blocks_packed(gap)
    ph, praw = psrc.export_blocks_packed(gap)
    assert ph == jh and ph["hashes"] == HASHES[:1]
    assert list(psrc.export_blocks(gap)["blocks"]) == HASHES[:1]
    header, raw = psrc.export_blocks_packed(HASHES)
    one = psrc.export_blocks_packed(HASHES[:1])

    # a cached root is skipped
    for mk in (_jax, _port):
        eng = mk(mha)
        assert eng.import_blocks_packed(*one) == 1
        assert eng.import_blocks_packed(header, raw) == len(HASHES) - 1
        assert eng.cached_block_hashes() == set(HASHES)
    # a pool of 5 with 4 blocks live: each import after the first evicts
    # the block the one before parked (the last write wins); a pool with
    # every block live: the stop, nothing changed
    results = {}
    for name, mk in (("jax", _jax), ("port", _port)):
        eng = mk(mha, num_blocks=5)
        eng.add_request(list(range(1, 21)), max_new_tokens=12)   # 4 blocks
        eng._try_admit()
        assert eng.blocks.num_free == 1
        got = eng.import_blocks_packed(header, raw)
        results[name] = (got, eng.cached_block_hashes(),
                         eng.blocks.evictions,
                         eng.export_blocks_packed(HASHES[-1:]))
        full = mk(mha, num_blocks=4)
        full.add_request(list(range(1, 21)), max_new_tokens=12)
        full._try_admit()
        before = _state(full)
        assert full.import_blocks_packed(header, raw) == 0
        _same_state(_state(full), before)
    assert results["port"][:3] == results["jax"][:3]
    assert results["port"][:3] == (len(HASHES), set(HASHES[-1:]),
                                   len(HASHES) - 1)
    assert results["port"][3] == results["jax"][3] == \
        psrc.export_blocks_packed(HASHES[-1:])


def test_pull_blocks_is_not_ported(mha):
    """The name is older than the port of ``pull_blocks``: the pull now
    computes.  A port engine pulls the warm chain off another port
    engine's ``BlockWireServer`` on 127.0.0.1: every block imported, the
    payload's bytes those of the source's packed export, and the prompt
    then served on them with its locally warmed tokens."""
    from paddle_tpu_torch.inference.blockwire import BlockWireServer

    src, dst = _port(mha), _port(mha)
    _warm(src)
    header, raw = src.export_blocks_packed(HASHES)
    with BlockWireServer(src) as srv:
        assert src.wire_endpoint == srv.endpoint
        assert dst.pull_blocks(srv.endpoint, HASHES) == (len(HASHES),
                                                        len(raw))
    assert src.wire_endpoint is None
    assert dst.export_blocks_packed(HASHES) == (header, raw)
    got = _warm(dst, n=8)
    assert dst.prefix_hit_blocks == len(HASHES)
    local = _port(mha)
    _warm(local)
    assert _warm(local, n=8) == got
