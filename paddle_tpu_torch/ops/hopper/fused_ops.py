"""Fused rotary embedding and SwiGLU — Hopper kernels K2, K3 and B6b
(``csrc/fused_ops.cu``).

Port of ``paddle_tpu/ops/pallas/fused_ops.py``: ``rope_fused`` replaces
``_rope_one_pallas`` (one launch rotates q and k), ``rope_bwd_fused`` is
its backward ``_rope_bwd`` (the same kernel K2 rotating the cotangents by
-theta, i.e. with ``-sin``), ``swiglu_fused`` replaces ``_swiglu_pallas``
and ``swiglu_bwd_fused`` (B6b) ``_swiglu_bwd_pallas``.  All are bound on the
H100 by bytes and make one read of each input and one write of each output
(see the source's note).

A wrapper runs the plain version (``_rope_ref`` / ``_swiglu_ref`` /
``_swiglu_bwd_ref``, the reference's jnp forms transcribed) only for CPU
tensors.  For CUDA tensors it launches the kernel or raises; ``launches``
counts kernel launches.  ``rope_fused`` and ``swiglu_fused`` are
differentiable: where a gradient is wanted they run inside a
``torch.autograd.Function`` whose backward is ``rope_bwd_fused`` (saving
only the cos/sin windows, as ``_rope_fwd``) or ``swiglu_bwd_fused``
(saving ``(a, b)``, as ``_swiglu_fwd``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["rope_fused", "rope_bwd_fused", "swiglu_fused",
           "swiglu_bwd_fused"]


def _rope_ref(q, k, cos, sin):
    def rot(x):
        xf = x.float()
        half = xf.shape[-1] // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        c = cos.float()[None, :, None, :]
        s = sin.float()[None, :, None, :]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _swiglu_ref(a, b):
    af = a.float()
    return (af * torch.sigmoid(af) * b.float()).to(a.dtype)


def _swiglu_bwd_ref(a, b, g):
    """The reference's jnp backward (``_swiglu_bwd``): (da, db)."""
    af, bf, gf = a.float(), b.float(), g.float()
    sig = torch.sigmoid(af)
    silu = af * sig
    da = gf * bf * (sig + silu * (1.0 - sig))
    db = gf * silu
    return da.to(a.dtype), db.to(b.dtype)


def _rope_launch(fn, q, k, cos, sin):
    """K2 on CUDA tensors, counted on ``fn`` (the forward or the
    backward wrapper)."""
    name = fn.__name__
    B, S, H, D = q.shape
    KVH = k.shape[2]
    if k.shape[:2] != (B, S) or k.shape[3] != D or D % 2:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must share B, S and an even D")
    for x in (q, k):
        if x.stride(3) != 1 or (x.shape[2] > 1 and x.stride(2) != D):
            raise ValueError(f"{name}: each token's [heads, D] must be "
                             "contiguous")
    for t in (cos, sin):
        if (t.shape != (S, D // 2) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name}: cos/sin must be contiguous float32 "
                             f"[{S}, {D // 2}] on {q.device}")
    dt, stream = _build.launch_args(name, q, k)
    oq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    ok = torch.empty((B, S, KVH, D), dtype=k.dtype, device=k.device)
    if B * S:
        with _build.device_guard(q):
            _build.check(_build.lib().ptt_rope(
                q.data_ptr(), k.data_ptr(), oq.data_ptr(), ok.data_ptr(),
                cos.data_ptr(), sin.data_ptr(), B, S, H, KVH, D,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1), dt,
                stream), name)
        fn.launches += 1
    return oq, ok


def _rope_fwd(q, k, cos, sin):
    if q.device.type == "cpu":
        return _rope_ref(q, k, cos, sin)
    return _rope_launch(rope_fused, q, k, cos, sin)


def rope_bwd_fused(gq: torch.Tensor, gk: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rope backward (``_rope_bwd``): the cotangents of the rotated
    (q, k) rotated by -theta, i.e. K2 with ``-sin``; shapes as
    ``rope_fused``."""
    if gq.device.type == "cpu":
        return _rope_ref(gq, gk, cos, -sin)
    return _rope_launch(rope_bwd_fused, gq.contiguous(), gk.contiguous(),
                        cos, torch.neg(sin))


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope_fwd(q, k, cos, sin)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        dq, dk = rope_bwd_fused(gq, gk, cos, sin)
        return dq, dk, None, None


def rope_fused(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, D], k [B, S, KVH, D], cos/sin [S, D/2] float32 ->
    rotated (q, k), neox half-split, float32 math, in q's dtype.  q and k
    may be strided over B and S; each head's [D] must be contiguous.
    Differentiable in q and k."""
    if _build.wants_grad(q, k):
        return _Rope.apply(q, k, cos, sin)
    return _rope_fwd(q, k, cos, sin)


def _check_same(name, *tensors):
    a = tensors[0]
    for t in tensors:
        if t.shape != a.shape or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and of one "
                             f"shape, got {[tuple(x.shape) for x in tensors]}")


def _swiglu_fwd(a, b):
    if a.device.type == "cpu":
        return _swiglu_ref(a, b)
    name = "swiglu_fused"
    _check_same(name, a, b)
    dt, stream = _build.launch_args(name, a, b)
    out = torch.empty_like(a)
    if a.numel():
        with _build.device_guard(a):
            _build.check(_build.lib().ptt_swiglu(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), dt,
                stream), name)
        swiglu_fused.launches += 1
    return out


def swiglu_bwd_fused(a: torch.Tensor, b: torch.Tensor,
                     g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B6b: the gradients (da, db) of silu(a) * b for the output
    cotangent g, sigmoid recomputed from a, float32 math, in a's dtype; a,
    b, g contiguous, one shape and dtype."""
    if a.device.type == "cpu":
        return _swiglu_bwd_ref(a, b, g)
    name = "swiglu_bwd_fused"
    g = g.contiguous()
    _check_same(name, a, b, g)
    dt, stream = _build.launch_args(name, a, b, g)
    da, db = torch.empty_like(a), torch.empty_like(b)
    if a.numel():
        with _build.device_guard(a):
            _build.check(_build.lib().ptt_swiglu_bwd(
                a.data_ptr(), b.data_ptr(), g.data_ptr(), da.data_ptr(),
                db.data_ptr(), a.numel(), dt, stream), name)
        swiglu_bwd_fused.launches += 1
    return da, db


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _swiglu_fwd(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return swiglu_bwd_fused(a, b, g)


def swiglu_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) * b with float32 math, in a's dtype; a, b contiguous, same
    shape.  Differentiable (backward: kernel B6b)."""
    if _build.wants_grad(a, b):
        return _SwiGLU.apply(a, b)
    return _swiglu_fwd(a, b)


rope_fused.launches = 0
rope_bwd_fused.launches = 0
swiglu_fused.launches = 0
swiglu_bwd_fused.launches = 0
