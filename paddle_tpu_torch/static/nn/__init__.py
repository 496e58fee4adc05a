"""``paddle.static.nn`` — the port of ``paddle_tpu/static/nn/__init__.py``,
as far as the port's layers go: the control flow (``control_flow.py``)
and the layer functions over ops the port has, ``fc``, ``embedding`` and
``layer_norm``.  A layer function makes its parameters at the call, on its
input's device (``static.create_parameter``: Xavier-normal weights from
torch's default generator, zero biases, unit scales), then applies the op:
eagerly, or recorded into the current program when its input is a program
variable.  The rest of the reference's 38 names (the convolutions and
norms beside ``layer_norm``, ``prelu``, ``nce``, the sequence ops of
``sequence_lod.py``, ...) wait for the layers and initializers of ROADMAP
A10a and raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import static as st
from ...nn import _check_attr
from ...nn import functional as F
from .control_flow import (  # noqa: F401
    case,
    cond,
    py_func,
    static_pylayer,
    switch_case,
    while_loop,
)

__all__ = [
    "fc", "batch_norm", "bilinear_tensor_product", "embedding", "case",
    "cond", "static_pylayer", "conv2d", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "data_norm", "deform_conv2d", "group_norm",
    "instance_norm", "layer_norm", "nce", "prelu", "py_func", "row_conv",
    "spectral_norm", "switch_case", "while_loop", "sparse_embedding",
    "sequence_conv", "sequence_softmax", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_slice",
    "sequence_expand", "sequence_expand_as", "sequence_pad",
    "sequence_unpad", "sequence_reshape", "sequence_scatter",
    "sequence_enumerate",
]


def _param(shape, dtype, device, fill=None, attr=None):
    """A parameter of the layer function: ``fill`` a constant, else the
    Xavier-normal default; an ``attr`` carrying an initializer raises (as
    ``nn._check_attr`` does)."""
    _check_attr(attr, "param_attr")
    p = st.create_parameter(list(shape), dtype, is_bias=fill is not None,
                            device=device)
    if fill not in (None, 0.0):
        with torch.no_grad():
            p.fill_(fill)
    return p


def _act(out, act: Optional[str]):
    if act is None:
        return out
    fn = getattr(F, act, None) or getattr(torch.nn.functional, act)
    return fn(out)


def fc(x, size: int, num_flatten_dims: int = 1, weight_attr=None,
       bias_attr=None, activation: Optional[str] = None, name=None):
    """Flatten each input's dims from ``num_flatten_dims`` on and project
    to ``size`` (a list of inputs: their projections summed), plus a bias
    unless ``bias_attr`` is False, then ``activation``."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = None
    for xi in xs:
        shape = tuple(xi.shape)
        nfd = num_flatten_dims if num_flatten_dims >= 0 else len(shape) - 1
        in_dim = int(np.prod(shape[nfd:]))
        w = _param([in_dim, size], xi.dtype, xi.device, attr=weight_attr)
        y = xi.reshape(*shape[:nfd], in_dim) @ w
        out = y if out is None else out + y
    if bias_attr is not False:
        b = _param([size], xs[0].dtype, xs[0].device, fill=0.0,
                   attr=bias_attr)
        out = out + b
    return _act(out, activation)


def embedding(input, size, is_sparse=False, is_distributed=False,  # noqa: A002
              padding_idx=None, param_attr=None, dtype="float32"):
    """Rows of a new [size[0], size[1]] table for the ids ``input``; a
    ``padding_idx`` row reads as zeros."""
    w = _param(list(size), st.to_dtype(dtype), input.device, attr=param_attr)
    out = torch.nn.functional.embedding(input.long(), w)
    if padding_idx is not None:
        pad = padding_idx if padding_idx >= 0 else size[0] + padding_idx
        out = out * (input != pad).unsqueeze(-1).to(out.dtype)
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,  # noqa: A002
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """Normalize over the dims from ``begin_norm_axis`` on, with a scale of
    ones and a shift of zeros unless ``scale`` / ``shift`` is False."""
    norm_shape = [int(s) for s in input.shape[begin_norm_axis:]]
    w = (_param(norm_shape, input.dtype, input.device, fill=1.0,
                attr=param_attr) if scale else None)
    b = (_param(norm_shape, input.dtype, input.device, fill=0.0,
                attr=bias_attr) if shift else None)
    out = torch.nn.functional.layer_norm(input, norm_shape, w, b, epsilon)
    return _act(out, act)


def _waits(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"static.nn.{name}: its layer is not ported yet (ROADMAP A10a)")
    refuse.__name__ = name
    return refuse


for _name in __all__:
    if _name not in globals():
        globals()[_name] = _waits(_name)
del _name
