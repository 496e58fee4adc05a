"""Fused RMSNorm (+ residual add) — Hopper kernel K1 (``csrc/fused_norm.cu``).

Port of ``paddle_tpu/ops/pallas/fused_norm.py``: ``rms_norm_fused``
replaces ``_pallas_rms`` and ``rms_norm_residual_fused`` replaces
``_pallas_rms_residual``.  Bound on the H100 by bytes; one block per row
keeps the float32 row in shared memory between its two passes (see the
source's note).

A wrapper runs the plain version (``_ref_rms`` / ``_ref_rms_residual``, a
transcription of the Pallas kernels) only for CPU tensors.  For CUDA tensors
it launches the kernel or raises; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["rms_norm_fused", "rms_norm_residual_fused"]


def _ref_rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x.dtype)


def _ref_rms_residual(x, residual, w, eps):
    s = x.float() + residual.float()
    return _ref_rms(s, w, eps).to(x.dtype), s.to(x.dtype)


def _check(name, x, w, *others):
    h = x.shape[-1]
    if w.shape != (h,):
        raise ValueError(f"{name}: weight shape {tuple(w.shape)} != ({h},)")
    for t in (x, w, *others):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in others:
        if t.shape != x.shape:
            raise ValueError(f"{name}: residual shape {tuple(t.shape)} != "
                             f"{tuple(x.shape)}")


def _launch(fn, x, r, w, eps):
    name = fn.__name__
    _check(name, x, w, *([] if r is None else [r]))
    dt, stream = _build.launch_args(name, x, w, *([] if r is None else [r]))
    out = torch.empty_like(x)
    res_out = None if r is None else torch.empty_like(x)
    h = x.shape[-1]
    n = x.numel() // h
    if n:
        with _build.device_guard(x):
            _build.check(_build.lib().ptt_rms_norm(
                x.data_ptr(), None if r is None else r.data_ptr(),
                w.data_ptr(), out.data_ptr(),
                None if res_out is None else res_out.data_ptr(),
                n, h, float(eps), dt, stream), name)
        fn.launches += 1
    return out, res_out


def rms_norm_fused(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x [..., H], w [H] -> x * rsqrt(mean(x^2) + eps) * w, float32
    statistics, in x's dtype."""
    if x.device.type == "cpu":
        return _ref_rms(x, w, eps)
    out, _ = _launch(rms_norm_fused, x, None, w, eps)
    return out


def rms_norm_residual_fused(x: torch.Tensor, residual: torch.Tensor,
                            w: torch.Tensor, eps: float = 1e-6):
    """-> (rms(x + residual) * w, x + residual): the sum is taken in
    float32 and normalized unrounded; ``residual_out`` is it in x's
    dtype."""
    if x.device.type == "cpu":
        return _ref_rms_residual(x, residual, w, eps)
    return _launch(rms_norm_residual_fused, x, residual, w, eps)


rms_norm_fused.launches = 0
rms_norm_residual_fused.launches = 0
