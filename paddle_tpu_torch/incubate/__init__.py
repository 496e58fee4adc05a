"""The port of ``paddle_tpu.incubate``: the fused functional APIs
(``incubate.nn.functional``) that the port has so far, and
``incubate.jit.inference`` (``paddle_tpu/incubate/__init__.py:301-335``),
the no-grad ``jit.to_static`` decorator."""
from __future__ import annotations

import torch

__all__ = ["inference", "jit"]


def inference(function=None, cache_static_model=False, **kwargs):
    """parity: incubate.jit.inference — decorate a layer (or a function) so
    its calls run through ``jit.to_static`` under ``torch.no_grad``: one
    CUDA graph per input signature on the card.  The reference's engine
    knobs (trt, ...) are accepted and ignored."""

    def wrap(fn_or_layer):
        from ..jit import to_static

        compiled = to_static(fn_or_layer)

        def fwd(*args, **kw):
            with torch.no_grad():
                return compiled(*args, **kw)

        if isinstance(fn_or_layer, torch.nn.Module):
            fn_or_layer.forward = fwd
            return fn_or_layer
        return fwd

    if function is not None:
        return wrap(function)
    return wrap


class _JitNamespace:
    """The reference's ``paddle.incubate.jit`` namespace."""

    inference = staticmethod(inference)


jit = _JitNamespace()
