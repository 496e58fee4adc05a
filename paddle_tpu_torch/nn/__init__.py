"""The parameter-holding layers of the port, with paddle's layouts.

Counterparts: ``paddle_tpu/nn/layer/common.py`` ``Linear``/``Dropout``/
``Embedding``, ``nn/layer/norm.py`` ``LayerNorm``/``RMSNorm``, and
``distributed/fleet/mp_layers.py`` Column/Row/VocabParallel layers at mp=1
(``ParallelLinear``, ``Embedding``: they hold the same parameters).  A
``Linear`` weight is ``[in, out]`` (``y = x @ W + b``), not torch's
``[out, in]``, so a paddle_tpu ``state_dict`` loads one for one
(``load_numpy_state_dict``).  The transformer layers are in
``nn/transformer.py``; ``torch.nn.ModuleList``/``Sequential`` stand for
paddle's ``LayerList``/``Sequential`` under the same attribute names.

``Linear`` and ``ParallelLinear`` are one ``torch.matmul`` (the reference
leaves it to XLA; operands of two float dtypes are promoted as jnp
promotes them, so a bfloat16 activation times a float32 weight is a
float32 product), ``Embedding`` one ``index_select`` (its backward an
``index_add_``, which needs no host sync), ``LayerNorm``
``torch.nn.functional.layer_norm`` (not a TPU kernel in the reference;
over an input of another dtype than its parameters it normalizes in the
input's dtype and then scales and shifts under jnp's promotion, as the
reference's jnp formula does),
``RMSNorm`` kernel K1 (``ops/hopper/fused_norm.py``), ``Dropout`` the
functional's seeded masks.  Under AMP each layer casts its inputs by its
op's tag in the reference (``linear``, ``embedding``, ``layer_norm``,
``rms_norm``; ``amp.amp_cast``).  The gradient clips of ``nn/clip.py`` are
exported here, as the reference's are.  Parameters are
trainable (``requires_grad=True``, the reference's ``stop_gradient=False``);
the inference entry points run under ``torch.no_grad``.  Layers take
``device=None`` (CUDA, or ``RuntimeError`` without it; ``device="cpu"`` for
the plain path), a ``dtype``, and draw random weights from an explicit
``torch.Generator``, never from global random state.  A ``weight_attr`` /
``bias_attr`` may be None, a name, or a ``ParamAttr``-like object without
an initializer; one that carries an initializer (or an initializer given
directly) raises ``NotImplementedError``: initializers are
``nn/initializer``, not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..amp.auto_cast import amp_cast
from ..device import resolve_device
from ..ops.hopper.fused_norm import rms_norm_fused
from . import functional as F
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
)

__all__ = ["Linear", "ParallelLinear", "Embedding", "LayerNorm", "RMSNorm",
           "Dropout", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "load_numpy_state_dict"]


def _xavier(in_features: int, out_features: int, device, dtype,
            generator: torch.Generator) -> nn.Parameter:
    """``[in, out]`` Xavier-uniform, paddle's default Linear initializer."""
    bound = math.sqrt(6.0 / (in_features + out_features))
    w = torch.empty(in_features, out_features, device=resolve_device(device),
                    dtype=dtype)
    w.uniform_(-bound, bound, generator=generator)
    return nn.Parameter(w)


def _check_attr(attr, what: str = "weight_attr"):
    """Refuse a parameter attribute the port cannot honour: an initializer
    (a ``ParamAttr`` carrying one, or one given directly, as
    ``ParamAttr._to_attr`` reads it), a frozen or rescaled parameter.
    None, False (no parameter, where the layer allows it), a name and a
    plain ``ParamAttr`` pass."""
    if attr is None or attr is False or isinstance(attr, str):
        return
    init = getattr(attr, "initializer", attr)
    if init is not None:
        raise NotImplementedError(
            f"{what} with an initializer: nn/initializer is not ported yet "
            "(ROADMAP A10)")
    if (not getattr(attr, "trainable", True)
            or getattr(attr, "learning_rate", 1.0) != 1.0):
        raise NotImplementedError(
            f"{what}: a frozen or rescaled parameter is not ported")


class Linear(nn.Module):
    """``y = x @ weight + bias``: ``weight [in, out]`` Xavier-uniform,
    ``bias [out]`` zeros, or none with ``bias_attr=False``."""

    def __init__(self, in_features: int, out_features: int, *,
                 weight_attr=None, bias_attr=None, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        _check_attr(weight_attr)
        _check_attr(bias_attr, "bias_attr")
        self.weight = _xavier(in_features, out_features, device, dtype,
                              generator)
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(out_features, device=self.weight.device,
                        dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class ParallelLinear(nn.Module):
    """Column/RowParallelLinear at mp=1: ``weight [in, out]``
    Xavier-uniform and, unless ``has_bias`` is False (the default, as
    Llama's projections use them), ``bias [out]`` zeros; ``has_bias=None``
    is a bias, as ColumnParallelLinear reads it.  The column form
    (``row=False``) adds the bias inside the product's op (``F.linear(x,
    w, b)``, ``mp_layers.py:70-89``), the row form after it, as an "add"
    of its own (``mp_layers.py:96-115``; under AMP the two cast
    differently).  Not a ``Linear``, as the reference's mp layers are not,
    so the weight-only int8 rewrite of ``inference.Predictor`` leaves them
    as they are, as the reference's does."""

    def __init__(self, in_features: int, out_features: int, *,
                 has_bias: Optional[bool] = False, row: bool = False,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.row = row
        self.weight = _xavier(in_features, out_features, device, dtype,
                              generator)
        self.bias = (None if has_bias is False else nn.Parameter(
            torch.zeros(out_features, device=self.weight.device,
                        dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return F.linear(x, self.weight)
        if not self.row:
            return F.linear(x, self.weight, self.bias)
        out, b = amp_cast("add", F.linear(x, self.weight), self.bias)
        return out + b


class Embedding(nn.Module):
    """``weight [num_embeddings, dim]`` ~ N(0, 1), as VocabParallelEmbedding
    initializes it."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        w = torch.empty(num_embeddings, embedding_dim,
                        device=resolve_device(device), dtype=dtype)
        w.normal_(0.0, 1.0, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        (w,) = amp_cast("embedding", self.weight)
        rows = w.index_select(0, ids.reshape(-1).long())
        return rows.view(*ids.shape, w.shape[1])


class LayerNorm(nn.Module):
    """``(x - mean) / sqrt(var + eps) * weight + bias`` over the trailing
    ``normalized_shape`` (biased variance, ``nn/functional/norm.py:87``);
    ``weight`` ones, ``bias`` zeros, either left out with
    ``weight_attr=False`` / ``bias_attr=False`` (``nn/layer/norm.py:98-119``).
    An input of another dtype than the parameters is normalized in its own
    dtype, then scaled and shifted under jnp's promotion (a bfloat16 input
    with float32 parameters gives float32), as the reference's formula."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None, *,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_attr(weight_attr)
        _check_attr(bias_attr, "bias_attr")
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.register_parameter("weight", None if weight_attr is False else
                                nn.Parameter(torch.ones(
                                    self._normalized_shape, device=dev,
                                    dtype=dtype)))
        self.register_parameter("bias", None if bias_attr is False else
                                nn.Parameter(torch.zeros(
                                    self._normalized_shape, device=dev,
                                    dtype=dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = amp_cast("layer_norm", x, self.weight, self.bias)
        if all(p is None or p.dtype == x.dtype for p in (w, b)):
            return torch.nn.functional.layer_norm(
                x, self._normalized_shape, w, b, self._epsilon)
        out = torch.nn.functional.layer_norm(x, self._normalized_shape,
                                             eps=self._epsilon)
        if w is not None:
            out = out * w
        return out if b is None else out + b


class Dropout(nn.Module):
    """``F.dropout`` while training; the identity in eval or at p == 0."""

    def __init__(self, p: float = 0.5, axis=None,
                 mode: str = "upscale_in_train"):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)



class RMSNorm(nn.Module):
    """``weight [hidden]`` = ones; the forward is kernel K1."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = amp_cast("rms_norm", x, self.weight)
        return rms_norm_fused(x, w, self.epsilon)


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; a bfloat16 array (ml_dtypes) is read by its
    raw 16-bit pattern, so no import of ml_dtypes is needed."""
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def load_numpy_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]):
    """Copy ``{name: np.ndarray}`` (paddle_tpu's ``state_dict`` as numpy)
    into ``model``'s parameters, converting to each parameter's dtype and
    device.  Raises ``KeyError`` on a missing or extra name and
    ``ValueError`` on a shape mismatch, before copying anything."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(sd))
    extra = sorted(set(sd) - set(params))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in params.items():
        if tuple(sd[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(sd[name].shape)} does "
                             f"not match the parameter's {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_tensor_from_numpy(np.asarray(sd[name])))
    return model
