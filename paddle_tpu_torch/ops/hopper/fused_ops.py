"""Fused rotary embedding and SwiGLU — Hopper kernels K2 and K3
(``csrc/fused_ops.cu``).

Port of the forward half of ``paddle_tpu/ops/pallas/fused_ops.py``:
``rope_fused`` replaces ``_rope_one_pallas`` (one launch rotates q and k)
and ``swiglu_fused`` replaces ``_swiglu_pallas``.  Both are bound on the
H100 by bytes and make one read of each input and one write of each output
(see the source's note).  The backward kernels come with training.

A wrapper runs the plain version (``_rope_ref`` / ``_swiglu_ref``, the
reference's jnp forms transcribed) only for CPU tensors.  For CUDA tensors
it launches the kernel or raises; ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

__all__ = ["rope_fused", "swiglu_fused"]


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


def rope_fused(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, D], k [B, S, KVH, D], cos/sin [S, D/2] float32 ->
    rotated (q, k), neox half-split, float32 math, in q's dtype.  q and k
    may be strided over B and S; each head's [D] must be contiguous."""
    if q.device.type == "cpu":
        return _rope_ref(q, k, cos, sin)
    name = "rope_fused"
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
        rope_fused.launches += 1
    return oq, ok


def swiglu_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) * b with float32 math, in a's dtype; a, b contiguous, same
    shape."""
    if a.device.type == "cpu":
        return _swiglu_ref(a, b)
    name = "swiglu_fused"
    if a.shape != b.shape or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: a and b must be contiguous and of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    dt, stream = _build.launch_args(name, a, b)
    out = torch.empty_like(a)
    if a.numel():
        with _build.device_guard(a):
            _build.check(_build.lib().ptt_swiglu(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), dt,
                stream), name)
        swiglu_fused.launches += 1
    return out


rope_fused.launches = 0
swiglu_fused.launches = 0
