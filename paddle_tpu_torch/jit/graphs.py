"""CUDA graphs over the port's device loops — the counterpart of the
reference's ``jax.jit`` program caches.

The reference compiles a loop once for each static signature and runs
the compiled program after that (``compile_count`` counts the programs).
``GraphCache`` does the same with CUDA graphs: the caller names a key for
each static signature and hands over a function of device tensors and
its inputs as numpy arrays.

* **Static inputs.**  A graph reads fixed device buffers.  Each key owns
  one device buffer per input, refilled before every call from pinned
  host staging with ``copy_(..., non_blocking=True)``, so filling waits
  for nothing.
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
  outputs for its own temporaries).
* **Launch counters.**  A replay runs no Python wrapper.  A capture
  records how far each kernel counter moved while it was captured (every
  integer attribute named ``*launches`` of the objects ``counters()``
  returns), puts the counters back (nothing ran), and each replay adds
  those deltas.
* **No fallback.**  A capture or a replay that fails raises.

``captures`` counts the graphs captured over the cache's life;
``clear()`` drops every graph (the caller's weights moved), and the next
call of each key warms up and captures again.  ``seconds`` holds each
key's first call and capture times (host clock, the first call
synchronised).  The module knows nothing of what it captures.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["GraphCache", "CapturedGraph", "StaticInputs"]

Counters = Callable[[], Dict[str, Any]]


def _snapshot(counters: Dict[str, Any]) -> Dict[Tuple[str, str], int]:
    return {(name, attr): v for name, fn in counters.items()
            for attr, v in vars(fn).items()
            if attr.endswith("launches") and isinstance(v, int)}


class StaticInputs:
    """One device buffer per input array (its shape and dtype), filled from
    host staging (pinned on CUDA) without waiting."""

    def __init__(self, arrays: Sequence[np.ndarray], device: torch.device):
        host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        pin = device.type == "cuda"
        self.host = [torch.empty(h.shape, dtype=h.dtype, pin_memory=pin)
                     for h in host]
        self.tensors = [torch.empty(h.shape, dtype=h.dtype, device=device)
                        for h in host]

    def fill(self, arrays: Sequence[np.ndarray]):
        if len(arrays) != len(self.tensors):
            raise ValueError(f"{len(arrays)} inputs for a graph of "
                             f"{len(self.tensors)}")
        for h, d, a in zip(self.host, self.tensors, arrays):
            src = torch.from_numpy(np.ascontiguousarray(a))
            if src.shape != h.shape or src.dtype != h.dtype:
                raise ValueError(f"graph input {tuple(src.shape)} "
                                 f"{src.dtype}: its buffer is "
                                 f"{tuple(h.shape)} {h.dtype}")
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

    def replay(self, arrays: Sequence[np.ndarray]):
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
    a call (CUDA graphs by default; the tests pass a stand-in)."""

    def __init__(self, device, counters: Optional[Counters] = None,
                 capture: Optional[Callable] = None):
        self.device = torch.device(device)
        self.counters = counters or dict
        self._capture = capture or _cuda_capture
        self.pool = None
        self.graphs: Dict[Hashable, CapturedGraph] = {}
        self.captures = 0
        self.seconds: Dict[Hashable, Tuple[float, float]] = {}

    def clear(self):
        """Drop every graph (their inputs, outputs and pool memory go with
        the last reference)."""
        self.graphs.clear()

    def run(self, key: Hashable, fn: Callable, arrays: Sequence[np.ndarray]):
        """``fn(*device inputs)`` for ``arrays``: a replay of ``key``'s
        graph, or on the key's first call an eager run (the returned
        results) followed by the capture."""
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
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
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
