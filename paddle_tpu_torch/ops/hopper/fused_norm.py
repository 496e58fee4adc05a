"""Fused RMSNorm (+ residual add) — Hopper kernel K1 (``csrc/fused_norm.cu``).

Port of ``paddle_tpu/ops/pallas/fused_norm.py``: ``rms_norm_fused``
replaces ``_pallas_rms`` and ``rms_norm_residual_fused`` replaces
``_pallas_rms_residual``.  Bound on the H100 by bytes: one memory round
trip, the row held in registers between the sum of squares and the scaling
(see the source's note).

``rms_plan(n, h, dtype, aligned)`` picks the launch from host sizes only:
16-byte packs where H and every pointer allow them (else one element a
pack), the packs a thread holds (1, 2, 4 or 8: the compiled instances), the
threads sharing a row (an aligned lane group of 1-16, or whole warps up to
1024) and the rows of a block.  The smallest holding that fits a row in one
block's registers wins, so a decode row of 4096 bf16 takes 512 threads of
one pack each; a row past every instance's registers keeps what fits and
reads the rest twice.  Any H runs.  ``_launch(..., **force)`` forces a
plan (``chip_smoke.py``'s edges and ``--k1-sweep``).

A wrapper runs the plain version (``_ref_rms`` / ``_ref_rms_residual``, a
transcription of the Pallas kernels) only for CPU tensors.  For CUDA tensors
it launches the kernel or raises; ``launches`` counts kernel launches.
Each forward is a ``torch.library`` op (``paddle_tpu_torch::rms_norm``,
``::rms_norm_residual``; ``_build.kernel_op``): its real implementation
checks, plans from the tensors' addresses, launches and counts; its fake
one states the output shapes, so ``torch.export`` traces the op without
reading an address or launching anything (``jit/serialization.py``).

Both are differentiable: each op's "Autograd" implementation
(``_build.autograd_op``) runs it, where a gradient is wanted, inside a
``torch.autograd.Function`` that saves its inputs, and the backward is the
reference's own vjp transcribed into plain torch ops (``_rms_bwd`` from
``fused_norm.py:_bwd``, ``_rms_residual_bwd`` from ``_bwd_res``, which
recomputes the sum in float32 and sends ``dsum`` to both inputs): the
reference has no Pallas kernel there, and XLA fuses its jnp.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

__all__ = ["rms_norm_fused", "rms_norm_residual_fused", "rms_plan",
           "RmsPlan"]

SMS = 132              # the H100's streaming multiprocessors
PERS = (1, 2, 4, 8)    # packs a thread holds: the compiled instances
BLOCK = 256            # threads a block aims at where a row takes fewer


def max_threads(held: int) -> int:
    """A block's thread limit for an instance whose threads hold ``held``
    floats (the source's ``__launch_bounds__``: 64 registers a thread at
    1024 threads)."""
    return 1024 if held <= 16 else 256


def _row_threads(packs: int) -> int:
    """Threads for ``packs`` packs of a row, one each: a power of two below
    32 (an aligned lane group), else whole warps."""
    if packs <= 16:
        return 1 << max(0, packs - 1).bit_length()
    return -(-packs // 32) * 32


def _valid_tpr(tpr: int) -> bool:
    return (0 < tpr < 32 and tpr & (tpr - 1) == 0) or (
        32 <= tpr <= 1024 and tpr % 32 == 0)


@dataclass(frozen=True)
class RmsPlan:
    """One K1 launch: ``vec`` 16-byte packs of ``pack`` elements (else one
    element a pack), ``per`` packs a thread holds, ``tpr`` threads a row,
    ``rows`` rows a block of ``threads`` threads, ``blocks`` in the grid;
    ``wide``: the row has more packs than ``per * tpr``, and the others are
    read twice."""

    vec: bool
    pack: int
    per: int
    tpr: int
    rows: int
    threads: int
    blocks: int
    wide: bool


def rms_plan(n: int, h: int, dtype: torch.dtype, aligned: bool, *,
             vec: Optional[bool] = None, per: Optional[int] = None,
             tpr: Optional[int] = None) -> RmsPlan:
    """The K1 launch for ``n`` rows of ``h`` in ``dtype``; ``aligned``:
    every pointer of the call is 16-byte aligned.  The keywords force a
    choice; a forced plan the instances do not take raises ``ValueError``.

    Packs of 16 bytes where ``aligned`` and h is a multiple of them.  The
    smallest ``per`` whose row threads (one pack each) stay within its
    instance's block limit; past every limit, the holding of the most
    packs (then the most threads), the rest of the row read twice.  Rows of
    fewer than ``BLOCK`` threads share a block, fewer of them while the grid
    is under ``SMS`` blocks."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rms_plan: float32 or bfloat16, got {dtype}"
                         f"{_build.f16_note(dtype)}")
    if n < 1 or h < 1:
        raise ValueError(f"rms_plan: n, h >= 1, got {n}, {h}")
    v16 = 16 // dtype.itemsize
    can = aligned and h % v16 == 0
    if vec is None:
        vec = can
    elif vec and not can:
        raise ValueError("rms_plan: 16-byte packs need aligned pointers and "
                         f"h % {v16} == 0")
    pack = v16 if vec else 1
    nv = h // pack

    def cap(p):
        return max_threads(p * pack)

    if per is None:
        if tpr is not None:
            raise ValueError("rms_plan: tpr is forced together with per")
        per = next((p for p in PERS
                    if _row_threads(-(-nv // p)) <= cap(p)), None)
        if per is None:          # past every instance's registers
            per = max(PERS, key=lambda p: (p * cap(p), -p))
    if per not in PERS:
        raise ValueError(f"rms_plan: per {per} not in {PERS}")
    if tpr is None:
        tpr = min(_row_threads(-(-nv // per)), cap(per))
    if not _valid_tpr(tpr) or tpr > cap(per):
        raise ValueError(f"rms_plan: {tpr} threads a row with {per} packs "
                         "each")
    low = max(1, 32 // tpr)             # a block of whole warps
    rows = max(low, BLOCK // tpr)
    while rows > low and -(-n // rows) < SMS:
        rows //= 2
    return RmsPlan(vec=vec, pack=pack, per=per, tpr=tpr, rows=rows,
                   threads=tpr * rows, blocks=-(-n // rows),
                   wide=per * tpr < nv)


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


def _launch(fn, x, r, w, eps, **force):
    """K1 on CUDA tensors, counted on ``fn``; ``force``: ``rms_plan``'s
    keywords."""
    name = fn.__name__
    others = [] if r is None else [r]
    _check(name, x, w, *others)
    dt, stream = _build.launch_args(name, x, w, *others)
    out = torch.empty_like(x)
    res_out = None if r is None else torch.empty_like(x)
    h = x.shape[-1]
    n = x.numel() // h if h else 0
    if n:
        ptrs = [x, w, out] + ([] if r is None else [r, res_out])
        plan = rms_plan(n, h, x.dtype,
                        all(t.data_ptr() % 16 == 0 for t in ptrs), **force)
        with _build.device_guard(x):
            _build.check(_build.lib().ptt_rms_norm(
                x.data_ptr(), None if r is None else r.data_ptr(),
                w.data_ptr(), out.data_ptr(),
                None if res_out is None else res_out.data_ptr(),
                n, h, float(eps), int(plan.vec), plan.per, plan.tpr,
                plan.rows, dt, stream), name)
        fn.launches += 1
    return out, res_out


@_build.kernel_op("rms_norm(Tensor x, Tensor w, float eps) -> Tensor",
                  fake=lambda x, w, eps: x.new_empty(x.shape))
def _rms_fwd(x, w, eps):
    if x.device.type == "cpu":
        return _ref_rms(x, w, eps)
    return _launch(rms_norm_fused, x, None, w, eps)[0]


@_build.kernel_op("rms_norm_residual(Tensor x, Tensor residual, Tensor w, "
                  "float eps) -> (Tensor, Tensor)",
                  fake=lambda x, r, w, eps: (x.new_empty(x.shape),
                                             x.new_empty(x.shape)))
def _rms_residual_fwd(x, residual, w, eps):
    if x.device.type == "cpu":
        return _ref_rms_residual(x, residual, w, eps)
    return _launch(rms_norm_residual_fused, x, residual, w, eps)


def _rms_bwd(x, w, g, eps):
    """The reference's ``_bwd``: (dx in x's dtype, dw in w's dtype), float32
    math."""
    xf, gf, wf = x.float(), g.float(), w.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0).to(w.dtype)
    gx_hat = gf * wf
    dx = inv * (gx_hat - xhat * torch.mean(gx_hat * xhat, dim=-1,
                                           keepdim=True))
    return dx.to(x.dtype), gw


def _rms_residual_bwd(x, residual, w, g_out, g_res, eps):
    """The reference's ``_bwd_res``: the pre-norm sum recomputed in float32,
    ``dsum = dx + g_res`` to both inputs."""
    s = x.float() + residual.float()
    dx, gw = _rms_bwd(s, w, g_out, eps)
    dsum = dx + g_res.float()
    return dsum.to(x.dtype), dsum.to(residual.dtype), gw


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, gw = _rms_bwd(x, w, g, ctx.eps)
        return dx, gw, None


class _RmsNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, w, eps):
        ctx.save_for_backward(x, residual, w)
        ctx.eps = eps
        return _rms_residual_fwd(x, residual, w, eps)

    @staticmethod
    def backward(ctx, g_out, g_res):
        x, residual, w = ctx.saved_tensors
        return (*_rms_residual_bwd(x, residual, w, g_out, g_res, ctx.eps),
                None)


def rms_norm_fused(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x [..., H], w [H] -> x * rsqrt(mean(x^2) + eps) * w, float32
    statistics, in x's dtype."""
    return _build.call_op(_rms_fwd, _RmsNorm, x, w, eps)


def rms_norm_residual_fused(x: torch.Tensor, residual: torch.Tensor,
                            w: torch.Tensor, eps: float = 1e-6):
    """-> (rms(x + residual) * w, x + residual): the sum is taken in
    float32 and normalized unrounded; ``residual_out`` is it in x's
    dtype."""
    return _build.call_op(_rms_residual_fwd, _RmsNormResidual, x, residual,
                          w, eps)


_build.autograd_op(_rms_fwd, _RmsNorm)
_build.autograd_op(_rms_residual_fwd, _RmsNormResidual)
rms_norm_fused.launches = 0
rms_norm_residual_fused.launches = 0
