"""Binary KV data plane — direct worker-to-worker block streaming for
disaggregated prefill/decode (Mooncake transfer-engine / DistServe
shape: arXiv:2407.00079, arXiv:2401.09670).

Copied from ``paddle_tpu/inference/blockwire.py`` (the port never
imports the JAX package); the wire format is the reference's, so a port
engine pulls from a JAX engine's listener and the reverse.  On the card
the listener thread's ``export_blocks_packed`` is one device gather and
one device-to-host copy.

The fabric's relay moves KV payloads over the pickle-over-HTTP *control*
channel, relayed through the frontend: every transferred block crosses
the wire twice as hundreds of per-block-per-layer numpy arrays.  This
module is that raw side channel: persistent TCP
sockets carrying length+CRC32-framed messages whose block payload is
ONE contiguous packed buffer per chain segment — a self-describing
geometry header (JSON) followed by the raw cache bytes.  No pickle on
the data plane, no per-array overhead, and the frontend orchestrates
with directory-sized control messages only.

Wire format (everything big-endian)::

    frame   := MAGIC(4) | u32 payload_len | u32 crc32(payload) | payload
    payload := kind(1) | body
    kind J  := JSON body — pull requests, typed errors, acks
    kind B  := u32 header_len | header JSON | raw packed bytes

The packed buffer's geometry rides the header (``shape`` =
``[2, layers, nblocks, kv_heads, block_size, head_dim]`` — K/V stacked
over the engine's native per-block cache slice), so the receiver can
reject a mismatched layout loudly BEFORE touching its cache, and a
truncated/torn stream fails the length or CRC check as a typed
:class:`WireError` — never a wrong or half-imported block.

Epoch fencing: the pull request carries the caller's epoch and the
serving side checks it against the SAME :class:`~.ha.EpochFence` the
worker's control RPCs fence through.  A stale puller gets a typed
``StaleEpoch`` error frame before any payload bytes move.  What is NOT
fenced: the bytes themselves — a frame already in flight when an epoch
bumps still lands, which is safe because imported blocks are
content-addressed (equal hash ⇒ equal bits) and publication back into
the directory re-checks the fence.

Failpoint: ``fabric.wire`` fires server-side per pull request (the
canonical registration lives here, mirrored in faults.KNOWN_SITES) —
an injected fault travels back as a typed error frame and the puller's
:meth:`~.kv_fabric.KVFabric.pull` degrades to the frontend relay, then
recompute, with token parity intact at every rung.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from .faults import register_failpoint
from .ha import EpochFence, StaleEpoch

__all__ = ["BlockWireServer", "WirePool", "WireError", "FABRIC_WIRE",
           "send_frame", "recv_frame", "pack_blocks", "unpack_blocks",
           "default_pool"]

FABRIC_WIRE = register_failpoint("fabric.wire")

MAGIC = b"PBW1"
_FRAME_HDR = struct.Struct(">4sII")          # magic, payload_len, crc32
KIND_JSON = b"J"
KIND_BLOCKS = b"B"
MAX_FRAME = 1 << 31                          # hard sanity bound on one frame


class WireError(RuntimeError):
    """Typed data-plane failure: torn frame, CRC mismatch, truncated
    stream, refused/absent peer, or an error frame from the serving
    side.  Callers degrade to the frontend relay — never retry into a
    half-read connection (the framing state is unrecoverable)."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`WireError` — a short
    read mid-frame means the peer died or the stream tore."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
        except OSError as e:
            raise WireError(f"wire read failed after {len(buf)}/{n} "
                            f"bytes: {e}") from e
        if not chunk:
            raise WireError(
                f"truncated stream: peer closed after {len(buf)}/{n} bytes")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, payload: bytes):
    hdr = _FRAME_HDR.pack(MAGIC, len(payload), zlib.crc32(payload))
    try:
        sock.sendall(hdr + payload)
    except OSError as e:
        raise WireError(f"wire write failed: {e}") from e


def recv_frame(sock: socket.socket, max_len: int = MAX_FRAME) -> bytes:
    magic, length, crc = _FRAME_HDR.unpack(_recv_exact(sock,
                                                       _FRAME_HDR.size))
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r} (torn or non-wire "
                        "stream)")
    if length > max_len:
        raise WireError(f"frame length {length} exceeds bound {max_len}")
    payload = _recv_exact(sock, length)
    got = zlib.crc32(payload)
    if got != crc:
        raise WireError(
            f"frame CRC mismatch: header {crc:#010x} vs payload "
            f"{got:#010x} — corrupt or torn frame")
    return payload


def pack_blocks(header: Dict, raw: bytes) -> bytes:
    """Block-data payload: kind byte, u32 header length, header JSON,
    then the packed cache bytes verbatim (one contiguous buffer)."""
    hb = json.dumps(header).encode()
    return KIND_BLOCKS + struct.pack(">I", len(hb)) + hb + raw


def unpack_blocks(payload: bytes) -> Tuple[Dict, bytes]:
    if len(payload) < 5 or payload[:1] != KIND_BLOCKS:
        raise WireError("expected a block-data frame")
    (hlen,) = struct.unpack(">I", payload[1:5])
    if 5 + hlen > len(payload):
        raise WireError(f"block frame header length {hlen} overruns the "
                        f"{len(payload)}-byte payload")
    try:
        header = json.loads(payload[5:5 + hlen].decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise WireError(f"undecodable block frame header: {e}") from e
    return header, payload[5 + hlen:]


def _pack_json(obj: Dict) -> bytes:
    return KIND_JSON + json.dumps(obj).encode()


def _unpack_json(payload: bytes) -> Dict:
    try:
        return json.loads(payload[1:].decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise WireError(f"undecodable control frame: {e}") from e


class BlockWireServer:
    """Data-plane listener over one engine: accepts persistent
    connections, answers ``pull`` requests with packed block frames.

    Shares the worker's :class:`EpochFence` (``_WORKER["fence"]`` in
    real workers; any fence for in-process fleets) so a deposed
    frontend's pull is rejected typed before any payload bytes move.
    ``engine.export_blocks_packed`` runs under ``self._lock`` — the
    listener thread and the worker's RPC handler threads share one
    engine, and the packed gather must not interleave with a step's
    cache writes.  A serving worker passes as ``lock`` the worker lock
    its CUDA-issuing RPC handlers hold (``fleet._WORKER["lock"]``): on
    the card no gather may run beside a step's CUDA graph capture."""

    def __init__(self, engine, *, fence: Optional[EpochFence] = None,
                 fault_injector=None, host: str = "127.0.0.1",
                 port: int = 0, advertise_host: Optional[str] = None,
                 lock=None):
        self.engine = engine
        self.fence = fence if fence is not None else EpochFence()
        self._faults = fault_injector
        self._lock = lock if lock is not None else threading.Lock()
        self.counters = {
            "serve_pulls_total": 0,    # block frames served
            "serve_bytes_total": 0,    # raw packed bytes served
            "serve_fenced_total": 0,   # stale-epoch handshakes rejected
            "serve_errors_total": 0,   # error frames sent (incl. injected)
        }
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self._port = self._sock.getsockname()[1]
        self._host = advertise_host or (host if host != "0.0.0.0"
                                        else "127.0.0.1")
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="blockwire-listener")
        self._thread.start()
        # stamp the engine so KVFabric.pull's ladder sees the direct rung
        engine.wire_endpoint = self.endpoint

    @property
    def endpoint(self) -> str:
        return f"{self._host}:{self._port}"

    def close(self):
        self._stopped.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if getattr(self.engine, "wire_endpoint", None) == self.endpoint:
            self.engine.wire_endpoint = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- serving
    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                     # listener closed
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="blockwire-conn")
            t.start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stopped.is_set():
                try:
                    payload = recv_frame(conn)
                except WireError:
                    return                 # peer gone or stream torn: drop
                if payload[:1] != KIND_JSON:
                    return                 # protocol violation: drop conn
                req = _unpack_json(payload)
                if req.get("op") != "pull":
                    send_frame(conn, _pack_json(
                        {"op": "err", "kind": "WireError",
                         "msg": f"unknown op {req.get('op')!r}"}))
                    continue
                self._serve_pull(conn, req)
        except WireError:
            pass                           # reply write failed: drop conn
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _serve_pull(self, conn: socket.socket, req: Dict):
        hashes = [str(h) for h in req.get("hashes") or ()]
        try:
            if self._faults is not None:
                self._faults.fire(FABRIC_WIRE,
                                  detail=hashes[0][:12] if hashes else "")
            # the fence decides BEFORE any payload bytes move: a stale
            # puller gets a typed error frame, never a partial stream
            self.fence.check(req.get("epoch"), "fabric.wire")
            with self._lock:
                header, raw = self.engine.export_blocks_packed(hashes)
        except StaleEpoch as e:
            self.counters["serve_fenced_total"] += 1
            send_frame(conn, _pack_json({"op": "err", "kind": "StaleEpoch",
                                         "msg": str(e)}))
            return
        except Exception as e:  # noqa: BLE001 — injected wire fault or
            # export failure: typed error frame, connection stays usable
            self.counters["serve_errors_total"] += 1
            send_frame(conn, _pack_json({"op": "err",
                                         "kind": type(e).__name__,
                                         "msg": str(e)}))
            return
        self.counters["serve_pulls_total"] += 1
        self.counters["serve_bytes_total"] += len(raw)
        send_frame(conn, pack_blocks(header, raw))


class WirePool:
    """Small pool of persistent client connections, keyed by endpoint.
    A connection that errors mid-pull is closed, never returned — the
    framing state after a torn read is unrecoverable."""

    def __init__(self, max_idle_per_peer: int = 2,
                 connect_timeout: float = 5.0):
        self.max_idle_per_peer = int(max_idle_per_peer)
        self.connect_timeout = float(connect_timeout)
        self._idle: Dict[str, List[socket.socket]] = {}
        self._lock = threading.Lock()

    def _checkout(self, endpoint: str) -> Tuple[socket.socket, bool]:
        with self._lock:
            idle = self._idle.get(endpoint)
            if idle:
                return idle.pop(), True
        host, port = endpoint.rsplit(":", 1)
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=self.connect_timeout)
        except OSError as e:
            raise WireError(f"wire connect to {endpoint} failed: {e}") from e
        return sock, False

    def _checkin(self, endpoint: str, sock: socket.socket):
        with self._lock:
            idle = self._idle.setdefault(endpoint, [])
            if len(idle) < self.max_idle_per_peer:
                idle.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def pull(self, endpoint: str, hashes: Sequence[str], *,
             epoch: Optional[int] = None,
             timeout: float = 60.0) -> Tuple[Dict, bytes]:
        """One pull round trip: request frame out, block (or typed
        error) frame back.  Returns ``(header, raw)``.  Raises
        :class:`~.ha.StaleEpoch` when the serving side fenced the
        handshake, :class:`WireError` for every transport-level
        failure."""
        sock, reused = self._checkout(endpoint)
        try:
            sock.settimeout(timeout)
            send_frame(sock, _pack_json({"op": "pull",
                                         "hashes": list(hashes),
                                         "epoch": epoch}))
            payload = recv_frame(sock)
        except WireError:
            try:
                sock.close()
            except OSError:
                pass
            if reused:
                # the pooled conn may have idled out under us; one fresh
                # connection is a deterministic, bounded retry
                return self.pull(endpoint, hashes, epoch=epoch,
                                 timeout=timeout)
            raise
        except socket.timeout as e:
            try:
                sock.close()
            except OSError:
                pass
            raise WireError(f"wire pull from {endpoint} timed out "
                            f"after {timeout}s") from e
        if payload[:1] == KIND_JSON:
            err = _unpack_json(payload)
            self._checkin(endpoint, sock)   # error frames keep the conn
            if err.get("kind") == "StaleEpoch":
                raise StaleEpoch(err.get("msg", "fenced wire pull"))
            raise WireError(f"wire peer {endpoint} refused pull: "
                            f"[{err.get('kind')}] {err.get('msg')}")
        try:
            header, raw = unpack_blocks(payload)
        except WireError:
            try:
                sock.close()
            except OSError:
                pass
            raise
        self._checkin(endpoint, sock)
        return header, raw

    def close(self):
        with self._lock:
            socks = [s for idle in self._idle.values() for s in idle]
            self._idle.clear()
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


_DEFAULT_POOL: Optional[WirePool] = None
_DEFAULT_POOL_LOCK = threading.Lock()


def default_pool() -> WirePool:
    """Process-wide client pool (one per puller process is plenty —
    connections are keyed by peer endpoint inside)."""
    global _DEFAULT_POOL
    with _DEFAULT_POOL_LOCK:
        if _DEFAULT_POOL is None:
            _DEFAULT_POOL = WirePool()
        return _DEFAULT_POOL
