"""``DataLoader`` and ``default_collate_fn`` — the port of
``paddle_tpu/io/reader.py``.

- ``num_workers=0``: the reference's in-process prefetch (one thread
  fetching and collating ahead, order kept by sequence numbers).
- ``num_workers>0``: forked worker processes pull tagged index batches,
  collate them and write each batch into the shared-memory ring
  (``paddle_tpu_torch.native.ShmQueue``, built from the port's copy of
  ``shm_queue.cpp``) as numpy records; a batch the ring cannot carry (a
  type it does not encode, or larger than a slot) and a worker's error
  cross a multiprocessing queue pickled, as in the reference.  The parent
  restores the order.  The ring is always used: a build or open failure
  raises (``use_shared_memory`` is accepted and changes nothing).
- An ``IterableDataset`` is read in-process.

Batches come out as CPU tensors (numpy arrays become tensors, Python
numbers stay numbers, as the reference's ``_to_tensor`` leaves them); the
caller moves them to its device (``hapi.Model`` does).  ``places`` is
ignored, as the reference ignores it.  Workers collate in numpy (or CPU
torch) and never touch CUDA: a child forked from a process that holds a
CUDA context dies where it does.  Each worker runs with one torch thread.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import pickle
import queue
import threading
import time
import traceback

import numpy as np
import torch

from ..native import ShmQueue, decode_batch, encode_batch

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack samples into a batch: tensors with ``torch.stack``, arrays with
    ``np.stack``, ints as int64 and floats as float32 arrays; lists, tuples
    and dicts field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _to_tensor(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensor(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_tensor(v) for k, v in obj.items()}
    return obj


class _PrefetchIter:
    """In-process: one thread fetches and collates the batches in order
    into a bounded queue."""

    def __init__(self, loader):
        self.loader = loader
        self.collate = loader.collate_fn or default_collate_fn
        self.q: queue.Queue = queue.Queue(
            maxsize=max(2, loader.prefetch_factor))
        self._todo: queue.Queue = queue.Queue()
        for i, indices in enumerate(loader.batch_sampler):
            self._todo.put((i, indices))
        self._total = self._todo.qsize()
        self._stop = threading.Event()
        self._out_buf = {}
        self._next_out = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                seq, indices = self._todo.get_nowait()
            except queue.Empty:
                return
            try:
                batch = self.collate([self.loader.dataset[i]
                                      for i in indices])
                self.q.put((seq, batch))
            except Exception as e:  # raised in the caller's thread
                self.q.put((seq, e))

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_out >= self._total:
            self._stop.set()
            raise StopIteration
        while self._next_out not in self._out_buf:
            seq, item = self.q.get()
            self._out_buf[seq] = item
        item = self._out_buf.pop(self._next_out)
        self._next_out += 1
        if isinstance(item, Exception):
            self._stop.set()
            raise item
        return _to_tensor(item)


def _tree_flatten(obj):
    """(arrays, spec) of a nested list / tuple / dict of arrays, numbers
    and CPU tensors of a numpy dtype; ``TypeError`` for anything else."""
    arrays = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.dtype == torch.bfloat16 or o.device.type != "cpu":
                raise TypeError(f"no ring encoding for a {o.dtype} tensor "
                                f"on {o.device}")
            o = o.numpy()
        if isinstance(o, np.ndarray):
            arrays.append(o)
            return {"t": "a"}
        if isinstance(o, (int, float, np.integer, np.floating, bool,
                          np.bool_)):
            arrays.append(np.asarray(o))
            return {"t": "a"}
        if isinstance(o, (list, tuple)):
            return {"t": "l" if isinstance(o, list) else "u",
                    "c": [walk(x) for x in o]}
        if isinstance(o, dict):
            keys = list(o)
            return {"t": "d", "k": keys, "c": [walk(o[k]) for k in keys]}
        raise TypeError(f"unsupported type for shm transport: {type(o)}")

    return arrays, walk(obj)


def _tree_unflatten(spec, arrays, pos=None):
    pos = pos or [0]
    t = spec["t"]
    if t == "a":
        a = arrays[pos[0]]
        pos[0] += 1
        return a
    if t in ("l", "u"):
        items = [_tree_unflatten(c, arrays, pos) for c in spec["c"]]
        return items if t == "l" else tuple(items)
    return {k: _tree_unflatten(c, arrays, pos)
            for k, c in zip(spec["k"], spec["c"])}


def _worker_loop(dataset, collate, idx_q, out_q, init_fn, wid, shm_name,
                 num_workers, base_seed):
    """A forked worker: index batches in, collated batches into the ring
    (or pickled onto ``out_q`` where the ring cannot carry them), errors
    onto ``out_q`` with the worker's traceback."""
    from .. import io as _io

    torch.set_num_threads(1)
    info = _io.WorkerInfo(wid, num_workers, dataset)
    info.seed = base_seed + wid
    _io._worker_info = info
    try:
        if init_fn is not None:
            init_fn(wid)
        shm = ShmQueue(shm_name, create=False)
    except Exception as e:
        out_q.put((-1, RuntimeError(f"DataLoader worker {wid} could not "
                                    f"start: {e}\n{traceback.format_exc()}")))
        return
    while True:
        item = idx_q.get()
        if item is None:
            shm.close()
            return
        seq, indices = item
        try:
            batch = collate([dataset[i] for i in indices])
            try:
                arrays, spec = _tree_flatten(batch)
                payload = (json.dumps(spec).encode() + b"\x00"
                           + encode_batch(arrays))
                shm.push(payload, seq)
                continue
            except (TypeError, ValueError):
                pass    # a type or a size the ring does not carry
            # pickled here, by value: a queue would share a tensor's
            # storage with a worker that may have exited before the read
            out_q.put((seq, pickle.dumps(batch)))
        except Exception as e:  # must cross the pickle boundary
            out_q.put((seq, RuntimeError(
                f"DataLoader worker {wid} failed: {e}\n"
                f"{traceback.format_exc()}")))


class _ProcessIter:
    """Forked workers over the shared-memory ring; the parent pops the
    ring, restores the order and raises a worker's error."""

    def __init__(self, loader):
        self.loader = loader
        self.workers, self._shm = [], None
        collate = loader.collate_fn or default_collate_fn
        batches = list(loader.batch_sampler)
        self._total = len(batches)
        self._next_out = 0
        self._out_buf = {}
        nw = loader.num_workers
        self._shm = ShmQueue(
            f"/ptt_dl_{os.getpid()}_{id(self) & 0xFFFFFF:x}",
            slot_size=64 << 20, n_slots=max(2, loader.prefetch_factor) * nw)
        ctx = mp.get_context("fork")
        self._idx_q = ctx.Queue()
        self._out_q = ctx.Queue()
        for i, b in enumerate(batches):
            self._idx_q.put((i, list(b)))
        base_seed = int(np.random.randint(0, 2 ** 31 - 1))
        for wid in range(nw):
            self._idx_q.put(None)
            p = ctx.Process(target=_worker_loop,
                            args=(loader.dataset, collate, self._idx_q,
                                  self._out_q, loader.worker_init_fn, wid,
                                  self._shm.name.decode(), nw, base_seed),
                            daemon=True)
            p.start()
            self.workers.append(p)

    def _recv_one(self) -> bool:
        """Pull one batch or error from either transport; False if none
        came within the poll."""
        try:
            seq, item = self._out_q.get_nowait()
            self._out_buf[seq] = item
            return True
        except queue.Empty:
            pass
        got = self._shm.pop(timeout_ms=200)
        if got is None:
            return False
        seq, buf = got
        sep = bytes(buf).index(b"\x00")
        spec = json.loads(bytes(buf[:sep]).decode())
        self._out_buf[seq] = _tree_unflatten(spec, decode_batch(
            buf[sep + 1:]))
        return True

    def _fetch(self):
        timeout = self.loader.timeout
        deadline = time.monotonic() + timeout if timeout else None
        while self._next_out not in self._out_buf:
            if -1 in self._out_buf:     # a worker that could not start
                self._shutdown()
                raise self._out_buf.pop(-1)
            if self._recv_one():
                continue
            if any(not p.is_alive() and p.exitcode not in (0, None)
                   for p in self.workers):
                self._shutdown()
                raise RuntimeError(
                    "DataLoader worker process died unexpectedly (killed or "
                    "crashed before reporting an error)")
            if deadline is not None and time.monotonic() > deadline:
                self._shutdown()
                raise RuntimeError(f"DataLoader timed out after {timeout}s "
                                   "waiting for a worker batch")
        item = self._out_buf.pop(self._next_out)
        self._next_out += 1
        if isinstance(item, Exception):
            self._shutdown()
            raise item
        if isinstance(item, bytes):
            item = pickle.loads(item)
        return _to_tensor(item)

    def _shutdown(self):
        for p in self.workers:
            p.join(timeout=5 if self._next_out >= self._total else 0)
            if p.is_alive():
                p.terminate()
                p.join()
        self.workers = []
        if self._shm is not None:
            self._shm.close()
            self._shm = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_out >= self._total:
            self._shutdown()
            raise StopIteration
        return self._fetch()

    def __del__(self):
        self._shutdown()


class _IterableIter:
    def __init__(self, loader):
        self.it = iter(loader.dataset)
        self.collate = loader.collate_fn or default_collate_fn
        self.batch_size = loader.batch_size
        self.drop_last = loader.drop_last

    def __iter__(self):
        return self

    def __next__(self):
        batch = []
        try:
            for _ in range(self.batch_size):
                batch.append(next(self.it))
        except StopIteration:
            if not batch or self.drop_last:
                raise
        return _to_tensor(self.collate(batch))


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        from .dataset import IterableDataset
        from .sampler import BatchSampler

        self.dataset = dataset
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable = isinstance(dataset, IterableDataset)
        if not self._iterable:
            self.batch_sampler = batch_sampler if batch_sampler is not None \
                else BatchSampler(dataset, shuffle=shuffle,
                                  batch_size=batch_size, drop_last=drop_last)

    def __iter__(self):
        if self._iterable:
            return _IterableIter(self)
        if self.num_workers > 0:
            return _ProcessIter(self)
        return _PrefetchIter(self)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()
