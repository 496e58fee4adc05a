"""User RPC: ``init_rpc`` / ``rpc_sync`` / ``rpc_async`` / ``shutdown`` /
``get_worker_info`` over plain HTTP (copied from
``paddle_tpu/distributed/rpc/__init__.py``, the parity of Paddle's
``distributed/rpc/rpc.py``, so that this package never imports the JAX one).

The control plane rides plain HTTP + the launch KV master for discovery
(``paddle_tpu_torch.distributed.launch.master``), not a native comm
library: RPC here is host-side orchestration (the serving fleet's worker
calls, parameter-server pulls), never the tensor hot path.  Payloads are
pickled like the reference's serialized Python functions (trusted-cluster
assumption, identical to the reference contract); the serving fleet's
replies carry host values only, never a CUDA tensor.
"""
from __future__ import annotations

import concurrent.futures
import http.server
import os
import pickle
import socket
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = ["init_rpc", "shutdown", "rpc_sync", "rpc_async", "get_worker_info",
           "get_all_worker_infos", "refresh_workers", "WorkerInfo",
           "RpcTimeout", "set_fault_injector"]


class WorkerInfo(NamedTuple):
    name: str
    rank: int
    ip: str
    port: int


class RpcTimeout(TimeoutError):
    """A per-call RPC deadline expired before the peer answered.

    Typed so callers that drive remote workers (the serving fleet's step
    loop, heartbeats) can treat a hung peer exactly like a dead one and
    fail over, instead of blocking the control loop behind a silent
    worker."""


_state: Dict[str, Any] = {
    "server": None, "name": None, "workers": {}, "pool": None, "kv": None,
    "thread": None,
}

# --------------------------------------------------------------------------
# fault injection (inference/faults.py failpoint registry): the 'rpc.send'
# site fires caller-side before each POST, so a chaos run can delay, drop,
# or time out specific calls deterministically.  Survives shutdown() —
# injector lifetime is the chaos run, not the rpc session.
# --------------------------------------------------------------------------
_fault_injector: Optional[Any] = None
_fault_env_checked = False


def set_fault_injector(inj) -> None:
    """Arm (or with None, disarm) the 'rpc.send' failpoint for this
    process; overrides any PADDLE_TPU_FAULTS env spec."""
    global _fault_injector, _fault_env_checked
    _fault_injector = inj
    _fault_env_checked = True


def _get_fault_injector():
    global _fault_injector, _fault_env_checked
    if not _fault_env_checked:
        _fault_env_checked = True
        # gate on the env var BEFORE importing: faults.py is stdlib-only
        # but lives under paddle_tpu_torch.inference, whose __init__ pulls
        # in torch — an rpc-only process (parameter server, launch
        # tooling) must not pay that import just to learn no faults are
        # armed
        if os.environ.get("PADDLE_TPU_FAULTS"):
            try:
                from ...inference.faults import FaultInjector
                _fault_injector = FaultInjector.from_env()
            except Exception:  # noqa: BLE001 — spec errors must not kill rpc
                _fault_injector = None
    return _fault_injector


class _RpcHandler(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        payload = self.rfile.read(n)
        token = _state.get("token")
        if token and self.headers.get("X-Paddle-Rpc-Token") != token:
            self.send_response(403)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        try:
            fn, args, kwargs = pickle.loads(payload)
            result = ("ok", fn(*args, **kwargs))
        except Exception as e:  # error travels back to the caller
            result = ("err", e)
        body = pickle.dumps(result)
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def init_rpc(name: str, rank: Optional[int] = None, world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None):
    """Start this worker's RPC server and register it for discovery.

    Discovery: a KV master endpoint ("ip:port" of a launch KVServer) when
    given / when PADDLE_MASTER is set; otherwise an in-process registry
    (single-process tests)."""
    import os

    if _state["server"] is not None:
        raise RuntimeError("init_rpc already called")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None else rank
    world_size = (int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
                  if world_size is None else world_size)
    master_endpoint = master_endpoint or os.environ.get("PADDLE_MASTER")

    port = _free_port()
    # Single-process / no-master mode never needs to be reachable from other
    # hosts: bind loopback only.  Multi-node (a KV master exists) binds all
    # interfaces and advertises a peer-reachable address; an optional shared
    # secret (PADDLE_RPC_TOKEN) gates unpickling on every request.
    bind_host = "0.0.0.0" if master_endpoint else "127.0.0.1"
    _state["token"] = os.environ.get("PADDLE_RPC_TOKEN")
    srv = _Server((bind_host, port), _RpcHandler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    _state["thread"] = thread
    ip = os.environ.get("PADDLE_LOCAL_IP")
    if not ip:
        if master_endpoint:
            try:
                ip = socket.gethostbyname(socket.gethostname())
            except OSError:
                ip = "127.0.0.1"
        else:
            ip = "127.0.0.1"
    info = WorkerInfo(name, rank, ip, port)
    _state.update(server=srv, name=name,
                  pool=concurrent.futures.ThreadPoolExecutor(max_workers=8))

    if master_endpoint:
        from ..launch.master import KVClient

        kv = KVClient(master_endpoint)
        _state["kv"] = kv
        kv.put(f"/rpc/workers/{name}", f"{rank}:{info.ip}:{port}")
        # wait for the full membership
        deadline = time.time() + 300
        while time.time() < deadline:
            entries = kv.get_prefix("/rpc/workers/")
            if len(entries) >= world_size:
                for key, val in entries.items():
                    wname = key.rsplit("/", 1)[-1]
                    r, ip, p = val.split(":")
                    _state["workers"][wname] = WorkerInfo(wname, int(r), ip, int(p))
                break
            time.sleep(0.05)
        else:
            raise TimeoutError("init_rpc: rendezvous timed out")
    else:
        _GLOBAL_REGISTRY[name] = info
        _state["workers"] = _GLOBAL_REGISTRY
    return info


_GLOBAL_REGISTRY: Dict[str, WorkerInfo] = {}


def get_worker_info(name: Optional[str] = None) -> WorkerInfo:
    if name is None:
        name = _state["name"]
    return _state["workers"][name]


def get_all_worker_infos() -> List[WorkerInfo]:
    return sorted(_state["workers"].values(), key=lambda w: w.rank)


def refresh_workers() -> Dict[str, WorkerInfo]:
    """Re-read worker membership from the KV master (dynamic fleets).

    The init-time rendezvous snapshot is static; a serving fleet adds and
    drains workers after init.  Rebuilds the routing table from the
    current ``/rpc/workers/`` prefix (always keeping this process's own
    entry) and returns it.  No-op without a KV master (the in-process
    registry is always current)."""
    kv = _state.get("kv")
    if kv is None:
        return dict(_state["workers"])
    entries = kv.get_prefix("/rpc/workers/")
    workers: Dict[str, WorkerInfo] = {}
    for key, val in entries.items():
        wname = key.rsplit("/", 1)[-1]
        r, ip, p = val.split(":")
        workers[wname] = WorkerInfo(wname, int(r), ip, int(p))
    own = _state.get("name")
    if own and own in _state["workers"]:
        workers.setdefault(own, _state["workers"][own])
    _state["workers"] = workers
    return dict(workers)


def _post(info: WorkerInfo, payload: bytes, timeout: float, ctx: str = ""):
    inj = _get_fault_injector()
    if inj is not None:
        # kind='timeout' raises the exact type a hung peer produces;
        # 'drop' raises ConnectionResetError like a SIGKILLed one; 'delay'
        # sleeps and proceeds.  Runs in the caller thread for rpc_sync and
        # in the pool thread for rpc_async, so async faults surface
        # through the future exactly like real transport faults.
        inj.fire("rpc.send", detail=f"{info.name}:{ctx}",
                 timeout_exc=RpcTimeout)
    headers = {}
    if _state.get("token"):
        headers["X-Paddle-Rpc-Token"] = _state["token"]
    req = urllib.request.Request(f"http://{info.ip}:{info.port}/", data=payload,
                                 headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, value = pickle.loads(r.read())
    except (socket.timeout, TimeoutError) as e:
        raise RpcTimeout(
            f"rpc to '{info.name}' ({info.ip}:{info.port}) timed out after "
            f"{timeout}s") from e
    except urllib.error.URLError as e:
        if isinstance(getattr(e, "reason", None), (socket.timeout, TimeoutError)):
            raise RpcTimeout(
                f"rpc to '{info.name}' ({info.ip}:{info.port}) timed out "
                f"after {timeout}s") from e
        raise
    if status == "err":
        # mark the exception as REMOTE (the peer answered and its
        # handler raised) so callers can tell it apart from a local
        # transport fault of the same type — e.g. a worker-side
        # ConnectionResetError failpoint vs a genuinely dead endpoint
        # (fleet.connect_workers prunes only the latter)
        try:
            value._rpc_remote = True
        except AttributeError:
            pass               # __slots__ exception: stays unmarked
        raise value
    return value


def rpc_sync(to: str, fn, args=(), kwargs=None, timeout: float = 300.0):
    """Run ``fn(*args, **kwargs)`` on worker ``to``; block for the result.

    ``timeout`` is a per-call deadline (connect + the remote execution):
    past it the call raises a typed ``RpcTimeout`` instead of blocking
    the caller behind a hung peer."""
    info = get_worker_info(to)
    payload = pickle.dumps((fn, tuple(args), dict(kwargs or {})))
    return _post(info, payload, timeout, ctx=getattr(fn, "__name__", ""))


def rpc_async(to: str, fn, args=(), kwargs=None, timeout: float = 300.0):
    """Like rpc_sync but returns a Future (``.wait()``/``.result()``);
    the future resolves to ``RpcTimeout`` past the per-call deadline."""
    info = get_worker_info(to)
    payload = pickle.dumps((fn, tuple(args), dict(kwargs or {})))
    fut = _state["pool"].submit(_post, info, payload, timeout,
                                getattr(fn, "__name__", ""))
    fut.wait = fut.result  # paddle Future parity
    return fut


def shutdown():
    srv = _state.get("server")
    if srv is not None:
        srv.shutdown()
        srv.server_close()  # release the listening socket now, not at GC
    pool = _state.get("pool")
    if pool is not None:
        # join the executor with a BOUNDED wait: queued-but-unstarted
        # calls are cancelled and idle/finishing workers are reaped (no
        # leaked threads on the normal path), but a call hung on a dead
        # peer must not hold shutdown() hostage for its full per-call
        # timeout — such stragglers are abandoned to finish (bounded by
        # that timeout) on their own
        pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.time() + 10
        for t in list(getattr(pool, "_threads", ())):
            t.join(timeout=max(0.0, deadline - time.time()))
    thread = _state.get("thread")
    if thread is not None:
        thread.join(timeout=10)
    name = _state.get("name")
    kv = _state.get("kv")
    if kv is not None and name:
        try:
            kv.delete(f"/rpc/workers/{name}")
        except Exception:
            pass
    _GLOBAL_REGISTRY.pop(name, None)
    _state.update(server=None, name=None, workers={}, pool=None, kv=None,
                  token=None, thread=None)
