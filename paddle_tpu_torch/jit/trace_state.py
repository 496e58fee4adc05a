"""The step's random context — the port of ``paddle_tpu/jit/trace_state.py``
(``TraceContext``, ``current``, ``activate``) for its random stream.

The reference traces a ``TrainStep`` once and feeds each call a fresh base
key; inside the trace every draw (a dropout mask) folds a counter into that
key, so each compiled call draws new masks.  The port runs the step
eagerly, and keeps the same keys: ``TrainStep`` makes one base key a step
on the device (``Generator.next_key``, no host sync) and activates a
``TraceContext`` over its forward; ``framework.random.Generator.next_key``
returns ``fold_in(base, i)`` for the i-th draw inside it, as the
reference's does.  A recomputed segment (``torch.utils.checkpoint``) draws
again in the backward: ``models/llama.py`` restores the counter it started
from, so the recomputation draws the forward's keys.

The reference's buffer updates (BatchNorm's running statistics inside a
trace) have no counterpart: the port's eager forward writes buffers as it
runs.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

__all__ = ["TraceContext", "current", "activate"]

_tls = threading.local()


class TraceContext:
    """A step's key chain: the i-th draw takes ``fold_in(base_key, i)``."""

    def __init__(self, base_key: torch.Tensor, counter: int = 0):
        self.base_key = base_key
        self._key_counter = counter

    def fork(self) -> "TraceContext":
        """A context on the same base key at this one's counter: its draws
        repeat the ones this context makes next (a recomputed segment)."""
        return TraceContext(self.base_key, self._key_counter)

    def next_key(self) -> torch.Tensor:
        from ..framework.random import fold_in

        self._key_counter += 1
        return fold_in(self.base_key, self._key_counter)

    @property
    def counter(self) -> int:
        """The number of keys drawn so far in this step."""
        return self._key_counter


def current() -> Optional[TraceContext]:
    return getattr(_tls, "ctx", None)


class activate:
    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        self.prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _tls.ctx = self.prev
        return False
