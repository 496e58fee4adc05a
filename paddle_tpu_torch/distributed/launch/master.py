"""Rendezvous master: an in-process HTTP KV store (copied from
paddle_tpu/distributed/launch/master.py, the parity of Paddle's launch
HTTPMaster, so that this package never imports the JAX one).

Node 0 serves a tiny threaded KV over HTTP; every node signs in with its
endpoint list; once all nodes are present the global rank order is the
sorted sign-in order.  The serving tier uses the same store for the
frontend lease (inference/ha.py) and the KV fabric's block directory
(inference/kv_fabric.py).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

__all__ = ["KVServer", "KVClient"]


class _Handler(BaseHTTPRequestHandler):
    kv: Dict[str, bytes] = {}
    lock = threading.Lock()

    def log_message(self, *args):  # silence default stderr logging
        pass

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        with self.lock:
            self.kv[self.path] = body
        self.send_response(200)
        self.end_headers()

    def do_GET(self):
        if self.path.startswith("/prefix"):
            prefix = self.path[len("/prefix"):]
            with self.lock:
                out = {k: v.decode() for k, v in self.kv.items() if k.startswith(prefix)}
            body = json.dumps(out).encode()
            self.send_response(200)
            self.end_headers()
            self.wfile.write(body)
            return
        with self.lock:
            body = self.kv.get(self.path)
        if body is None:
            self.send_response(404)
            self.end_headers()
        else:
            self.send_response(200)
            self.end_headers()
            self.wfile.write(body)

    def do_DELETE(self):
        with self.lock:
            self.kv.pop(self.path, None)
        self.send_response(200)
        self.end_headers()

    def do_POST(self):
        # /cas — atomic compare-and-swap, the primitive leases need (a
        # plain GET-then-PUT acquire would let two standbys both win the
        # race for an expired frontend lease).  Body: JSON
        # {"key": ..., "expect": str|null, "new": str}; expect=null means
        # "key must be absent".  Replies "1" (swapped) or "0" (lost).
        if self.path != "/cas":
            self.send_response(404)
            self.end_headers()
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(length).decode())
            key, expect, new = req["key"], req.get("expect"), req["new"]
        except (ValueError, KeyError):
            self.send_response(400)
            self.end_headers()
            return
        with self.lock:
            cur = self.kv.get(key)
            cur_s = cur.decode() if cur is not None else None
            ok = cur_s == expect
            if ok:
                self.kv[key] = new.encode()
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"1" if ok else b"0")


class KVServer:
    """The master-side store; runs in a daemon thread on node 0."""

    def __init__(self, port: int):
        # fresh class-level store per server instance
        handler = type("Handler", (_Handler,), {"kv": {}, "lock": threading.Lock()})
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()


class KVClient:
    def __init__(self, endpoint: str):
        self.base = f"http://{endpoint}"

    def put(self, key: str, value: str, timeout: float = 5) -> bool:
        req = urllib.request.Request(f"{self.base}{key}", data=value.encode(), method="PUT")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status == 200
        except OSError:
            return False

    def get(self, key: str) -> Optional[str]:
        try:
            with urllib.request.urlopen(f"{self.base}{key}", timeout=5) as r:
                if r.status == 200:
                    return r.read().decode()
        except OSError:
            return None
        return None

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        try:
            return self._get_prefix_raw(prefix)
        except OSError:
            return {}

    def delete(self, key: str) -> bool:
        req = urllib.request.Request(f"{self.base}{key}", method="DELETE")
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status == 200
        except OSError:
            return False

    def cas(self, key: str, expect: Optional[str], new: str,
            timeout: float = 5) -> bool:
        """Atomic compare-and-swap: install ``new`` under ``key`` iff the
        current value equals ``expect`` (``None`` = key absent).  Returns
        True when the swap happened — the read-modify-write primitive the
        serving frontend lease (inference/ha.py) is built on.  A
        transport fault reads as False: the caller must not assume it
        won."""
        body = json.dumps({"key": key, "expect": expect,
                           "new": new}).encode()
        req = urllib.request.Request(f"{self.base}/cas", data=body,
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status == 200 and r.read() == b"1"
        except OSError:
            return False

    def _get_prefix_raw(self, prefix: str) -> Dict[str, str]:
        with urllib.request.urlopen(f"{self.base}/prefix{prefix}", timeout=5) as r:
            return json.loads(r.read().decode())

    def wait_n(self, prefix: str, n: int, timeout: float = 300.0,
               abort_key: Optional[str] = None) -> Dict[str, str]:
        """Block until ``n`` keys exist under ``prefix`` (node sign-in barrier).

        ``abort_key``: fail fast if that key appears (a peer declared the job
        dead). A master that stays unreachable for ~20 consecutive polls also
        aborts — its controller has exited."""
        deadline = time.time() + timeout
        conn_errors = 0
        while time.time() < deadline:
            try:
                got = self._get_prefix_raw(prefix)
                conn_errors = 0
            except OSError:
                conn_errors += 1
                if conn_errors >= 20:
                    raise TimeoutError("rendezvous: master unreachable (peer controller exited?)")
                got = {}
            if len(got) >= n:
                return got
            if abort_key is not None and self.get(abort_key) is not None:
                raise TimeoutError(f"rendezvous: aborted — a peer marked the job failed ({abort_key})")
            time.sleep(0.2)
        raise TimeoutError(f"rendezvous: waited {timeout}s for {n} keys under {prefix}")
