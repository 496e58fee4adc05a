"""Graph breaks — the port of ``paddle_tpu/jit/lazy_segments.py``.

The reference records every op a ``to_static`` function dispatches while a
segment context is active, and flushes the recorded ops as one compiled
program at each host read (``.numpy()``, ``float()``, ``bool()``, ...), so
one read in the middle of a model gives two segments.  The port runs the
function eagerly, each op launched as it comes, and keeps the reference's
count of segments: ``BreakDetector`` is a ``TorchDispatchMode`` (the
port's counterpart of the reference's dispatch chokepoint) that sees every
aten op and custom op (the Hopper kernels) the function dispatches, and
marks a host read where it sees

- ``aten._local_scalar_dense`` (``item()``, ``float()``, ``int()``,
  ``bool()``) or ``aten.is_nonzero``;
- a copy to the CPU of a tensor on another device (``.cpu()``,
  ``.to("cpu")``, ``copy_`` into a CPU tensor);

and, through a ``TorchFunctionMode`` beside it, ``Tensor.numpy``,
``Tensor.tolist`` and ``Tensor.__array__``, which read a CPU tensor's
memory without dispatching an op.  A read ends the segment when an op ran
since the previous one (the reference flushes nothing for a read with
nothing recorded), and the ops after the last read make the last segment:
``segments`` is the reference's ``segments_run`` for the same function on
either device.  ``detach`` and ``alias`` are not ops here: they move no
data (``numpy()`` dispatches a ``detach`` of its own).

A constant is not data: a tensor the function makes from Python values
(a factory op such as ``torch.tensor`` or ``torch.ones``, or an op whose
tensor inputs are all such constants) is not an op of a segment, and
reading it is not a host read, as a ``jnp`` constant inside the
reference's trace is concrete (``framework.random.uniform`` rounds its
bounds through one).  An op with any other tensor input makes data, in
place too.

Detection never waits for a CUDA graph capture to fail: a capture that
hits a sync leaves the stream and the pool to be unwound.  A key's first
call runs under the detector before anything is captured.  With
``strict`` (``to_static(..., full_graph=True)``) the first read raises
``RuntimeError`` instead.  Running each segment as a CUDA graph of its
own is later work: a broken signature runs eagerly, every kernel launched
as the eager function launches it.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable

import torch
from torch.utils._pytree import tree_leaves
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["BreakDetector", "GraphBreak", "active", "run_segmented"]

_aten = torch.ops.aten
_SCALAR_READS = (_aten._local_scalar_dense.default, _aten.is_nonzero.default)
_FREE = (_aten.detach.default, _aten.alias.default)
# a tensor made from Python data (torch.tensor) enters through these
_LIFTS = (_aten.lift_fresh.default, _aten.lift_fresh_copy.default)
_ARRAY_READS = ("numpy", "tolist", "__array__")

_tls = threading.local()


class GraphBreak(RuntimeError):
    """A host read inside a ``full_graph=True`` function."""


def active() -> bool:
    """Whether a ``BreakDetector`` is running in this thread (a
    ``to_static`` function called inside another one's run is inlined)."""
    return getattr(_tls, "depth", 0) > 0


def _to_cpu_read(func, args, kwargs) -> bool:
    """A copy of a tensor on another device into host memory."""
    if func is _aten._to_copy.default:
        src, dev = args[0], kwargs.get("device")
        return (dev is not None and torch.device(dev).type == "cpu"
                and src.device.type != "cpu")
    if func is _aten.copy_.default:
        dst, src = args[0], args[1]
        return dst.device.type == "cpu" and src.device.type != "cpu"
    return False


class _ArrayReads(TorchFunctionMode):
    def __init__(self, detector: "BreakDetector"):
        super().__init__()
        self.detector = detector

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", None) in _ARRAY_READS
                and not self.detector._constant(args[0])):
            self.detector._read(f"Tensor.{func.__name__}")
        return func(*args, **(kwargs or {}))


class BreakDetector(TorchDispatchMode):
    """Counts the segments of one eager run (module docstring): enter it
    with ``with BreakDetector(): ...``; ``segments`` is final after the
    block, ``breaks`` names every host read."""

    def __init__(self, strict: bool = False, name: str = "fn"):
        super().__init__()
        self.strict = strict
        self.name = name
        self.segments = 0
        self.breaks = []
        self._ops = 0
        self._array_reads = _ArrayReads(self)
        self._constants = {}        # id -> weakref of a constant tensor

    def _constant(self, t) -> bool:
        ref = self._constants.get(id(t))
        return ref is not None and ref() is t

    def _read(self, what: str):
        if self.strict:
            raise GraphBreak(
                f"to_static({self.name}): graph break ({what}) with "
                "full_graph=True: the function reads a tensor on the host")
        self.breaks.append(what)
        if self._ops:
            self.segments += 1
            self._ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        constant = func in _LIFTS or all(self._constant(t) for t in ins)
        if constant:
            pass
        elif func in _SCALAR_READS or _to_cpu_read(func, args, kwargs):
            self._read(str(func))
        elif func not in _FREE:
            self._ops += 1
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            if constant:
                self._constants[id(t)] = weakref.ref(t)
            else:
                self._constants.pop(id(t), None)
        return out

    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1
        self._array_reads.__enter__()
        try:
            return super().__enter__()
        except BaseException:
            self._array_reads.__exit__(None, None, None)
            _tls.depth -= 1
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._array_reads.__exit__(*exc)
            _tls.depth -= 1
            self._constants.clear()
            if self._ops:
                self.segments += 1
                self._ops = 0


def run_segmented(fn: Callable, args, kwargs, name: str = "fn",
                  strict: bool = False):
    """``fn(*args, **kwargs)`` eagerly under a ``BreakDetector`` ->
    (output, the detector)."""
    det = BreakDetector(strict=strict, name=name)
    with det:
        out = fn(*args, **kwargs)
    return out, det
