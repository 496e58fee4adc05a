"""The shared-memory ring that carries DataLoader batches from worker
processes to the parent — the port of ``paddle_tpu/native/__init__.py``
over its own copy of ``shm_queue.cpp``.

The library is built with ``g++`` from ``shm_queue.cpp`` at first use into
``build/paddle_tpu_torch/libshm_queue.so`` at the repository root (rebuilt
when the source is newer), under the kernel build's file lock
(``ops/hopper/_build.py``), so processes starting together build it once.
A missing compiler, a failed compile or a ring that cannot be created or
opened raises, naming the compiler's or the system's error: there is no
path without the ring.  Batches cross it as numpy ``.npy`` records
(``encode_batch`` / ``decode_batch``), no pickle.
"""
from __future__ import annotations

import ctypes
import io
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..ops.hopper._build import BUILD_DIR, _locked

__all__ = ["ShmQueue", "build", "encode_batch", "decode_batch", "LIB_PATH"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "shm_queue.cpp")
LIB_PATH = os.path.join(BUILD_DIR, "libshm_queue.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _stale() -> bool:
    return (not os.path.exists(LIB_PATH)
            or os.path.getmtime(LIB_PATH) < os.path.getmtime(_SRC))


def build() -> str:
    """Compile the ring's library if it is missing or stale; return its
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    if not _stale():
        return LIB_PATH
    with _locked():
        if not _stale():
            return LIB_PATH
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH: the DataLoader's "
                               "shared-memory ring is built from "
                               f"{_SRC} at first use")
        tmp = LIB_PATH + ".tmp"
        proc = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-o", tmp,
                               _SRC, "-lpthread", "-lrt"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed to build the DataLoader's "
                               "shared-memory ring:\n" + proc.stdout
                               + proc.stderr)
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build(), use_errno=True)
            lib.shmq_create.restype = ctypes.c_void_p
            lib.shmq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_uint32]
            lib.shmq_open.restype = ctypes.c_void_p
            lib.shmq_open.argtypes = [ctypes.c_char_p]
            lib.shmq_push.restype = ctypes.c_int
            lib.shmq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_uint64,
                                      ctypes.c_int]
            lib.shmq_pop.restype = ctypes.c_int64
            lib.shmq_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64,
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.c_int]
            lib.shmq_slot_size.restype = ctypes.c_uint64
            lib.shmq_slot_size.argtypes = [ctypes.c_void_p]
            lib.shmq_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


# ------------------------------------------------------- batch (de)serialize
def encode_batch(arrays: List[np.ndarray]) -> bytes:
    """The arrays as concatenated ``.npy`` records, each after its length."""
    bio = io.BytesIO()
    bio.write(np.uint32(len(arrays)).tobytes())
    for a in arrays:
        sub = io.BytesIO()
        # np.ascontiguousarray alone would make a 0-d array 1-d
        np.save(sub, a if a.flags.c_contiguous else np.ascontiguousarray(a),
                allow_pickle=False)
        raw = sub.getvalue()
        bio.write(np.uint64(len(raw)).tobytes())
        bio.write(raw)
    return bio.getvalue()


def decode_batch(buf: memoryview) -> List[np.ndarray]:
    n = int(np.frombuffer(buf[:4], np.uint32)[0])
    off = 4
    out = []
    for _ in range(n):
        ln = int(np.frombuffer(buf[off:off + 8], np.uint64)[0])
        off += 8
        out.append(np.load(io.BytesIO(bytes(buf[off:off + ln])),
                           allow_pickle=False))
        off += ln
    return out


class ShmQueue:
    """The ring: ``create=True`` makes it (the parent, which unlinks it on
    ``close``), ``create=False`` opens it by name (a worker)."""

    def __init__(self, name: str, slot_size: int = 16 << 20,
                 n_slots: int = 8, create: bool = True):
        self._h = None
        lib = _load()
        self._lib = lib
        self.name = name.encode()
        self._h = (lib.shmq_create(self.name, slot_size, n_slots) if create
                   else lib.shmq_open(self.name))
        if not self._h:
            err = os.strerror(ctypes.get_errno())
            raise RuntimeError(f"shm_queue {'create' if create else 'open'} "
                               f"failed for {name}: {err}")
        self.slot_size = lib.shmq_slot_size(self._h)
        self._rx = None  # made on the first pop: workers only push

    def push(self, payload: bytes, seq: int, timeout_ms: int = -1) -> bool:
        """Write one payload; False on a timeout.  ``ValueError`` where it
        is larger than a slot."""
        rc = self._lib.shmq_push(self._h, payload, len(payload), seq,
                                 timeout_ms)
        if rc == -1:
            raise ValueError(f"payload of {len(payload)} bytes exceeds slot "
                             f"size {self.slot_size}")
        if rc == -2:
            raise RuntimeError("shm_queue push failed (semaphore/mutex "
                               "error)")
        return rc == 0

    def pop(self, timeout_ms: int = -1):
        """-> (seq, memoryview) or None on a timeout.  The view aliases one
        receive buffer: consume it before the next pop."""
        if self._rx is None:
            self._rx = ctypes.create_string_buffer(int(self.slot_size))
        seq = ctypes.c_uint64()
        n = self._lib.shmq_pop(self._h, self._rx, self.slot_size,
                               ctypes.byref(seq), timeout_ms)
        if n == -3:
            return None
        if n == -1:
            raise RuntimeError("shm_queue pop: receive buffer smaller than "
                               "payload")
        if n < 0:
            raise RuntimeError("shm_queue pop failed (semaphore/mutex "
                               "error)")
        return int(seq.value), memoryview(self._rx)[:n]

    def close(self):
        if self._h:
            self._lib.shmq_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
