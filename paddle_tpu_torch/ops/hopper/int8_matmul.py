"""Weight-only int8 matrix product — Hopper kernel B7
(``csrc/int8_matmul.cu``).

Port of ``paddle_tpu/ops/pallas/int8_matmul.py``: ``int8_matmul`` replaces
``_int8_mm_impl`` (its ``_kernel``).  ``x [..., K] @ qw [K, N]`` (int8,
per-column float32 ``scale [N]``) ``-> [..., N]`` in x's dtype: the weight
is widened per tile on the chip, the products are summed in float32, and
the scale is applied once, in float32, before the one cast.  Bound on the
H100 by operations at the predictor's row counts and by the weight's bytes
at a few rows (see the source's note).

The kernel takes every shape: there is no shape fallback on CUDA (the
reference falls back to a dequantize-then-matmul in x's dtype where M is not
a multiple of 8 or K or N not of 128; on those shapes the two differ by
rounding only) and no pad of M to 8 rows (a TPU sublane detail).  Rows of x
are read with their own stride: the classifier head's ``x[:, 0]`` is passed
as it is, without a copy; a column stride other than 1 is made contiguous.

For CPU tensors ``int8_matmul`` runs the plain version
(``_int8_matmul_ref``: ``(x.float() @ qw.float()) * scale`` cast to x's
dtype); for CUDA tensors it launches the kernel or raises.  An x other than
float32 or bfloat16, or a qw other than int8, raises on either device.
``int8_matmul.launches`` counts kernel launches.  The gradient flows to x
alone, ``dx = g @ (qw * scale)^T`` in g's dtype, plain torch as the
reference's jnp backward; qw and scale get none.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["int8_matmul"]

_X_DTYPES = (torch.float32, torch.bfloat16)


def _int8_matmul_ref(x2, qw, scale):
    """The plain version on [M, K] x [K, N]: float32 sums, the scale once
    after them, one cast to x's dtype."""
    return ((x2.float() @ qw.float()) * scale).to(x2.dtype)


def _check(x, qw, scale):
    name = "int8_matmul"
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if qw.dtype != torch.int8:
        raise TypeError(f"{name}: qw must be int8, got {qw.dtype}")
    if qw.dim() != 2 or x.shape[-1] != qw.shape[0]:
        raise ValueError(f"{name}: x [..., K] and qw [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(qw.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (qw.shape[1],):
        raise ValueError(f"{name}: scale must be float32 [{qw.shape[1]}], "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if not (qw.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: qw and scale must be contiguous")
    if not x.device == qw.device == scale.device:
        raise ValueError(f"{name}: x, qw and scale must share one device, "
                         f"got {x.device}, {qw.device}, {scale.device}")


def _launch(x2, qw, scale):
    """Kernel B7 on x2 [M, K] (unit column stride) -> [M, N]."""
    name = "int8_matmul"
    M, K = x2.shape
    N = qw.shape[1]
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M and N:
        dt, stream = _build.launch_args(name, x2)
        with _build.device_guard(x2):
            _build.check(_build.lib().ptt_int8_matmul(
                x2.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                out.data_ptr(), M, N, K, x2.stride(0), dt, stream), name)
        int8_matmul.launches += 1
    return out


def _forward(x, qw, scale):
    K, N = qw.shape
    x2 = x.reshape(-1, K)          # a view where the layout allows one
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    if x.device.type == "cpu":
        out = _int8_matmul_ref(x2, qw, scale)
    else:
        out = _launch(x2, qw, scale)
    return out.reshape(*x.shape[:-1], N)


class _Int8MatMul(torch.autograd.Function):
    """B7 forward; the backward to x through the dequantized weight, as
    the reference's ``_int8_mm_bwd``."""

    @staticmethod
    def forward(ctx, x, qw, scale):
        ctx.save_for_backward(qw, scale)
        return _forward(x, qw, scale)

    @staticmethod
    def backward(ctx, g):
        qw, scale = ctx.saved_tensors
        w = qw.to(g.dtype) * scale.to(g.dtype)[None, :]
        return g @ w.t(), None, None


def int8_matmul(x: torch.Tensor, qw: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] (float32 or bfloat16) @ qw [K, N] int8 * scale [N]
    float32 -> [..., N] in x's dtype.  Differentiable in x."""
    _check(x, qw, scale)
    if _build.wants_grad(x):
        return _Int8MatMul.apply(x, qw, scale)
    return _forward(x, qw, scale)


int8_matmul.launches = 0
