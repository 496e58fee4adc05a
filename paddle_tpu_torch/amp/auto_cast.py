"""AMP autocast — the port of ``paddle_tpu/amp/auto_cast.py`` (``auto_cast``,
``amp_guard``, ``amp_state``, ``decorate``, ``is_auto_cast_enabled``,
``get_amp_dtype``) with the reference's rules and lists, not
``torch.autocast``'s (the two lists differ).

O1: only white-list ops run in the low dtype.  O2: every op but the
black-list ones runs in it; the float32 master weights live in the
optimizer (``multi_precision``).  The reference casts at its dispatch
boundary by op name (``paddle_tpu/ops/dispatch.py`` ``_amp_cast_vals``).
The port has no dispatch layer, so each op of the port that has a tag in
the reference casts its own floating inputs through ``amp_cast(op_name,
...)`` by the same rules:

- a black-list op takes float32;
- a white-list op, or any op under O2, takes the low dtype (its float32
  inputs are cast);
- any other op keeps what it was given.

The casts are ``Tensor.to``, differentiable: a float32 parameter cast to
bfloat16 for a product gets a float32 gradient, as under the reference's
``jax.grad``.  The state is thread-local.  ``TrainStep``'s recomputed
layers (``torch.utils.checkpoint``) run in the backward, outside the
caller's ``with auto_cast()``: ``models/llama.py`` captures the state with
``snapshot`` in the forward and ``restore``s it around the recomputation.

float16 casts as the reference's; its kernels are not ported (ROADMAP F16):
on CUDA the first kernel that meets a float16 tensor raises.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Set

import torch

from . import amp_lists

__all__ = ["auto_cast", "amp_guard", "amp_state", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype", "amp_cast"]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.white: Set[str] = set()
        self.black: Set[str] = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def is_auto_cast_enabled() -> bool:
    return _state.enabled


def get_amp_dtype() -> str:
    return _state.dtype


def snapshot():
    """The calling thread's AMP state, for ``restore``."""
    return (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)


@contextlib.contextmanager
def restore(saved):
    """Run the block under the AMP state ``saved`` by ``snapshot``."""
    prev = snapshot()
    (_state.enabled, _state.dtype, _state.level, _state.white,
     _state.black) = saved
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.white,
         _state.black) = prev


class auto_cast:
    """Context manager: ``paddle.amp.auto_cast``."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"level must be O0, O1 or O2, got {level!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float16 or bfloat16, got "
                             f"{dtype!r}")
        self.enable = enable and level != "O0"
        self.level = level
        self.dtype = dtype
        self.white = ((amp_lists.WHITE_LIST | set(custom_white_list or ()))
                      - set(custom_black_list or ()))
        self.black = amp_lists.BLACK_LIST | set(custom_black_list or ())

    def __enter__(self):
        self._saved = snapshot()
        _state.enabled = self.enable
        _state.dtype = self.dtype
        _state.level = self.level
        _state.white = self.white
        _state.black = self.black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level, _state.white,
         _state.black) = self._saved
        return False


amp_guard = auto_cast


def amp_cast(op_name: str, *xs):
    """The inputs of the op tagged ``op_name`` as AMP casts them (see the
    module's rules); non-tensors and non-float tensors pass as they are.
    Returns a tuple, the inputs themselves when AMP is off."""
    st = _state
    if not st.enabled:
        return xs

    def is_float(x):
        return isinstance(x, torch.Tensor) and x.is_floating_point()

    if op_name in st.black:
        return tuple(x.float() if is_float(x) and x.dtype != torch.float32
                     else x for x in xs)
    if op_name in st.white or st.level == "O2":
        low = _DTYPES[st.dtype]
        return tuple(x.to(low) if is_float(x) and x.dtype == torch.float32
                     else x for x in xs)
    return xs


def _kept_fp32(module) -> bool:
    """The norms whose parameters O2 keeps in float32 (the reference's
    ``LayerNorm`` and ``_BatchNormBase``; ``RMSNorm`` is not one)."""
    from ..nn import LayerNorm

    return isinstance(module, (LayerNorm, torch.nn.LayerNorm,
                               torch.nn.modules.batchnorm._BatchNorm))


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """``paddle.amp.decorate``: O2 casts the models' floating parameters to
    the AMP dtype (LayerNorm and BatchNorm parameters stay float32, as
    the reference keeps them) in place, and switches the optimizers to
    ``multi_precision`` master weights unless ``master_weight`` is
    False."""
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        dt = _DTYPES[dtype]
        excl = ([] if not excluded_layers else list(excluded_layers)
                if isinstance(excluded_layers, (list, tuple))
                else [excluded_layers])
        for m in model_list:
            excluded = {id(sub) for sub in m.modules()
                        if any(isinstance(sub, e) if isinstance(e, type)
                               else sub is e for e in excl)}
            for sub in m.modules():
                if id(sub) in excluded or _kept_fp32(sub):
                    continue
                for p in sub._parameters.values():
                    if p is not None and p.is_floating_point():
                        p.data = p.data.to(dt)
            m._casted_by_pure_fp16 = True
    if optimizers is None:
        return models if single_model else model_list
    single_opt = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if single_opt else list(optimizers)
    if level == "O2" and (master_weight is None or master_weight):
        for opt in opt_list:
            opt._multi_precision = True
    return ((models if single_model else model_list),
            (optimizers if single_opt else opt_list))
