"""CUDA graphs over the port's device loops — the counterpart of the
reference's ``jax.jit`` program caches.

The reference compiles a loop once for each static signature and runs
the compiled program after that (``compile_count`` counts the programs).
``GraphCache`` does the same with CUDA graphs: the caller names a key for
each static signature and hands over a function of device tensors and
its inputs as numpy arrays.

* **Static inputs.**  A graph reads fixed device buffers.  Each key owns
  one device buffer per input, refilled before every call: a numpy array
  or a CPU tensor through host staging (pinned on CUDA) with
  ``copy_(..., non_blocking=True)``, a tensor on the device by a
  device-to-device copy, so filling waits for nothing.  A key with no
  inputs replays with no fill (its function reads state it owns).
* **State a key owns.**  ``state(key, make)`` keeps what a key's graph
  reads and writes besides its inputs (a KV ring, a token buffer), made on
  the key's first use; it lives and is dropped with the key's graph.  With
  ``max_keys`` set, a new key's state beyond it first drops the oldest
  key that holds state (its graph too), as the reference bounds its
  program caches.
* **Weights.**  ``weights``, where given, lists the tensors the graphs
  read but do not own (``module_tensors``: a module's parameters and
  buffers); ``watch()`` drops every graph and state when one of them is
  not at the address of the last call (a parameter replaced, not written
  in place), and each key warms up and captures again.
* **Warm-up, then capture.**  The first call of a key runs the function
  eagerly on its buffers; that call's outputs are the real results, and
  the lazy first-use work (the kernel library's build and load, the
  kernels' shared-memory attributes, cuBLAS's handle and workspace, plan
  and tile caches) happens there, outside any capture.  Then the function
  is captured.  A capture runs no kernel, so state the function updates
  in place (a KV cache) is written once per call, as without graphs.
  Later calls of the key fill the buffers and replay.
* **One memory pool.**  Every graph of a cache allocates from one pool
  (``torch.cuda.graph_pool_handle()``): its graphs never run at once, and
  the caller reads a replay's outputs before it runs any graph of the pool
  again (a graph captured later may use the memory of an earlier graph's
  outputs for its own temporaries).  Once every graph was dropped
  (``clear``, ``watch``), the next capture takes a new pool: PyTorch
  asserts on a capture into a pool whose graphs are all gone while their
  outputs still hold its memory (a serving worker's rolling weight swap
  did that).
* **Launch counters.**  A replay runs no Python wrapper.  A capture
  records how far each kernel counter moved while it was captured (every
  integer attribute named ``*launches`` of the objects ``counters()``
  returns), puts the counters back (nothing ran), and each replay adds
  those deltas.
* **No fallback.**  A capture or a replay that fails raises.

``captures`` counts the graphs captured over the cache's life;
``clear()`` drops every graph and state (the caller's weights moved),
``drop(key)`` one key's, and the next call of a key warms up and captures
again.  ``seconds`` holds each
key's first call and capture times (host clock, the first call
synchronised).  The module knows nothing of what it captures.
"""
from __future__ import annotations

import time
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

__all__ = ["GraphCache", "CapturedGraph", "StaticInputs", "module_tensors"]

Counters = Callable[[], Dict[str, Any]]


def module_tensors(module: torch.nn.Module
                   ) -> Callable[[], List[torch.Tensor]]:
    """A function listing ``module``'s parameters and buffers as they stand,
    read from the slots the module tree has now (cheaper on every call than
    a walk of the tree): a slot's tensor replaced
    (``Module.to``, ``load_state_dict(..., assign=True)``, a new
    ``Parameter``) shows; a submodule added later does not."""
    slots = [(d, n) for m in module.modules()
             for d in (m._parameters, m._buffers) for n in d]
    return lambda: [d[n] for d, n in slots if d[n] is not None]


def _snapshot(counters: Dict[str, Any]) -> Dict[Tuple[str, str], int]:
    return {(name, attr): v for name, fn in counters.items()
            for attr, v in vars(fn).items()
            if attr.endswith("launches") and isinstance(v, int)}


def _as_tensor(a) -> torch.Tensor:
    return (a if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(a)))


class StaticInputs:
    """One device buffer per input (its shape and dtype), filled without
    waiting: numpy arrays and CPU tensors through host staging (pinned on
    CUDA, made on a slot's first host fill), tensors already on the device
    by a device-to-device copy."""

    def __init__(self, arrays: Sequence, device: torch.device):
        srcs = [_as_tensor(a) for a in arrays]
        self.host = [None] * len(srcs)
        self.tensors = [torch.empty(s.shape, dtype=s.dtype, device=device)
                        for s in srcs]

    def fill(self, arrays: Sequence):
        if len(arrays) != len(self.tensors):
            raise ValueError(f"{len(arrays)} inputs for a graph of "
                             f"{len(self.tensors)}")
        for i, (d, a) in enumerate(zip(self.tensors, arrays)):
            src = _as_tensor(a)
            if src.shape != d.shape or src.dtype != d.dtype:
                raise ValueError(f"graph input {tuple(src.shape)} "
                                 f"{src.dtype}: its buffer is "
                                 f"{tuple(d.shape)} {d.dtype}")
            if src.device.type != "cpu" or d.device.type == "cpu":
                d.copy_(src)
                continue
            h = self.host[i]
            if h is None:
                h = self.host[i] = torch.empty(d.shape, dtype=d.dtype,
                                               pin_memory=True)
            h.copy_(src)
            d.copy_(h, non_blocking=True)
        return self.tensors


def _cuda_capture(fn: Callable[[], Any], pool) -> Tuple[Any, Any]:
    """Capture ``fn()`` into a CUDA graph in ``pool``: (graph, outputs)."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, pool=pool):
        out = fn()
    return g, out


class CapturedGraph:
    """A captured graph with its static inputs, its outputs and the launch
    counts it adds at each replay."""

    def __init__(self, graph, inputs: StaticInputs, outputs,
                 deltas: Dict[Tuple[str, str], int],
                 counters: Dict[str, Any]):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.deltas = deltas
        self.counters = counters

    def replay(self, arrays: Sequence = ()):
        """Fill the inputs, replay, count the launches; -> the outputs (the
        same tensors at every replay)."""
        self.inputs.fill(arrays)
        self.graph.replay()
        for (name, attr), n in self.deltas.items():
            fn = self.counters[name]
            setattr(fn, attr, getattr(fn, attr) + n)
        return self.outputs


class GraphCache:
    """Graphs by key over one memory pool (module docstring).

    ``counters`` returns the kernel wrappers whose ``*launches`` counts a
    replay must advance; ``capture(fn, pool) -> (graph, outputs)`` captures
    a call (CUDA graphs by default; the tests pass a stand-in);
    ``max_keys`` bounds the keys that hold state (None: unbounded);
    ``weights`` lists
    the tensors ``watch()`` checks."""

    def __init__(self, device, counters: Optional[Counters] = None,
                 capture: Optional[Callable] = None,
                 max_keys: Optional[int] = None,
                 weights: Optional[Callable[[], Sequence]] = None):
        self.device = torch.device(device)
        self.counters = counters or dict
        self._capture = capture or _cuda_capture
        self.max_keys = max_keys
        self.weights = weights or list
        self.pool = None
        self.graphs: Dict[Hashable, CapturedGraph] = {}
        self.states: Dict[Hashable, Any] = {}
        self._watched: Optional[Tuple[int, ...]] = None
        self.captures = 0
        self.seconds: Dict[Hashable, Tuple[float, float]] = {}

    def clear(self):
        """Drop every graph and state (their inputs, outputs and pool
        memory go with the last reference)."""
        self.graphs.clear()
        self.states.clear()

    def drop(self, key: Hashable):
        """Drop ``key``'s graph and state."""
        self.graphs.pop(key, None)
        self.states.pop(key, None)

    def _pool_for_capture(self):
        """The pool the next capture allocates from: a new one when no
        graph of the cache is left (a pool whose graphs were all dropped
        may still hold their outputs' memory, and PyTorch refuses a new
        capture into it; the old pool goes with its last tensor)."""
        if self.pool is None or not self.graphs:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool

    def watch(self):
        """Drop every graph and state when the ``weights`` (read by the
        graphs, owned by the caller) are not at the addresses of the last
        call."""
        ptrs = tuple(t.data_ptr() for t in self.weights())
        if ptrs != self._watched:
            self.clear()
            self._watched = ptrs

    def state(self, key: Hashable, make: Callable[[], Any]):
        """The state ``key`` owns, ``make()`` on the key's first use (after
        dropping the oldest keys that hold state, as ``max_keys`` asks)."""
        st = self.states.get(key)
        if st is None:
            while (self.max_keys is not None
                   and len(self.states) >= self.max_keys):
                self.drop(next(iter(self.states)))
            st = self.states[key] = make()
        return st

    def run(self, key: Hashable, fn: Callable, arrays: Sequence = ()):
        """``fn(*device inputs)`` for ``arrays`` (numpy arrays or tensors):
        a replay of ``key``'s graph, or on the key's first call an eager run
        (the returned results) followed by the capture."""
        graph = self.graphs.get(key)
        if graph is not None:
            return graph.replay(arrays)
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        inputs = StaticInputs(arrays, self.device)
        ins = inputs.fill(arrays)
        out = fn(*ins)
        if cuda:
            torch.cuda.synchronize(self.device)
            self._pool_for_capture()
        t1 = time.perf_counter()
        counters = self.counters()
        before = _snapshot(counters)
        g, outputs = self._capture(lambda: fn(*ins), self.pool)
        after = _snapshot(counters)
        deltas = {}
        for k, v in after.items():
            if v != before.get(k, 0):
                deltas[k] = v - before.get(k, 0)
            setattr(counters[k[0]], k[1], before.get(k, 0))
        self.graphs[key] = CapturedGraph(g, inputs, outputs, deltas,
                                         counters)
        self.captures += 1
        self.seconds[key] = (t1 - t0, time.perf_counter() - t1)
        return out
