"""Fused rotary embedding and SwiGLU — Hopper kernels K2, K3 and B6b
(``csrc/fused_ops.cu``).

Port of ``paddle_tpu/ops/pallas/fused_ops.py``: ``rope_fused`` replaces
``_rope_one_pallas`` (one launch rotates q and k), ``rope_bwd_fused`` is
its backward ``_rope_bwd`` (the same kernel K2 rotating the cotangents by
-theta: a sign flag negates sin as the kernel reads it, the bits of K2
given a ``-sin`` table), ``swiglu_fused`` replaces ``_swiglu_pallas`` and
``swiglu_bwd_fused`` (B6b) ``_swiglu_bwd_pallas``.  All are bound on the
H100 by bytes and make one read of each input and one write of each output
(see the source's note).

``rope_plan`` gives K2's launch from host sizes: a thread per (token, head,
chunk of 16 bytes of pairs) where D and every pointer and stride allow it,
else a thread per pair.  ``rope_fused(..., position_offset=off)`` takes the
whole [Smax, D/2] table and a 0-d integer tensor on q's device: the kernel
reads the offset and rotates by rows ``clamp(off, 0, Smax - S) + s`` (a
negative offset first counts from the end), the reference's
``lax.dynamic_slice_in_dim``, so no window is gathered first.
``rope_fused(..., interleaved=True)`` rotates the pairs (2j, 2j + 1) by
cos/sin[j] in the same one launch, ``rope_rotate``'s other style
(``paddle_tpu/ops/paged_attention.py:52-56``, blha_attention's
``use_neox_style=False``); the backward takes the same flag, the ring
mode does not.

``rope_ring_fused(q, k, v, cos, sin, kbuf, vbuf, pos)`` is K2's ring mode,
the generation path's static KV ring: one launch rotates q (returned),
writes the rotated k rows into ``kbuf`` and copies the v rows into
``vbuf`` at ring rows ``clamp(wrap(pos, L), 0, L - S) + s``
(``dynamic_update_slice``'s start, as ``kv_ring_write`` takes it), the
table rows taken from the same pos as ``rope_fused`` takes them.  It folds
B3's launch into K2's; its plain version is ``_rope_ref`` then
``_ref_ring_write``, and the ring gets the same bits.

A wrapper runs the plain version (``_rope_ref`` / ``_swiglu_ref`` /
``_swiglu_bwd_ref``, the reference's jnp forms transcribed) only for CPU
tensors.  For CUDA tensors it launches the kernel or raises; ``launches``
counts kernel launches.  ``rope_fused`` and ``swiglu_fused`` are
differentiable: where a gradient is wanted they run inside a
``torch.autograd.Function`` whose backward is ``rope_bwd_fused`` (saving
only the cos/sin tables and the offset, as ``_rope_fwd``) or
``swiglu_bwd_fused`` (saving ``(a, b)``, as ``_swiglu_fwd``).  The
forwards of ``rope_fused`` and ``swiglu_fused`` are ``torch.library``
ops (``paddle_tpu_torch::rope``, ``::swiglu``; ``_build.kernel_op``:
checks, plan, launch and count in the real implementation, shapes only in
the fake one), so ``torch.export`` keeps them as calls of the kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["rope_fused", "rope_bwd_fused", "rope_ring_fused", "rope_plan",
           "RopePlan", "swiglu_fused", "swiglu_bwd_fused"]

ROPE_THREADS = 128     # a K2 block's threads
_OFFSET_BYTES = {torch.int32: 4, torch.int64: 8}


@dataclass(frozen=True)
class RopePlan:
    """One K2 launch: ``vec`` 16-byte chunks of ``pairs`` pairs a thread
    (else one pair a thread), ``chunks`` a head, ``items`` threads (B * S *
    (H + KVH) * chunks, the chunk fastest) in ``blocks`` blocks."""

    vec: bool
    pairs: int
    chunks: int
    items: int
    blocks: int


def rope_plan(B: int, S: int, H: int, KVH: int, D: int, dtype: torch.dtype,
              aligned: bool, *, vec: Optional[bool] = None) -> RopePlan:
    """K2's launch from host sizes; ``aligned``: every pointer and every
    stride of the call is 16-byte aligned.  ``vec=False`` forces the scalar
    body (``chip_smoke.py``'s edges)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rope_plan: float32 or bfloat16, got {dtype}"
                         f"{_build.f16_note(dtype)}")
    cp = 16 // dtype.itemsize
    can = aligned and D % 2 == 0 and (D // 2) % cp == 0
    if vec is None:
        vec = can
    elif vec and not can:
        raise ValueError("rope_plan: 16-byte chunks need aligned pointers "
                         f"and strides and D / 2 % {cp} == 0")
    pairs = cp if vec else 1
    chunks = D // 2 // pairs
    items = B * S * (H + KVH) * chunks
    if items >= 1 << 31:
        raise ValueError(f"rope_plan: {items} threads past the 32-bit index")
    return RopePlan(vec=vec, pairs=pairs, chunks=chunks, items=items,
                    blocks=-(-items // ROPE_THREADS))


def _window(cos, sin, S, position_offset):
    """The rows a rotation of S positions reads: all of cos/sin without an
    offset, else rows clamp(off, 0, Smax - S) .. + S, a negative off
    counted from the end first (the reference's ``dynamic_slice_in_dim``;
    plain versions, CPU tensors)."""
    if position_offset is None:
        return cos, sin
    if cos.shape[0] < S:
        raise ValueError(f"rope: a table of {cos.shape[0]} rows for {S} "
                         "positions")
    start = int(position_offset)
    start += cos.shape[0] if start < 0 else 0
    start = min(max(start, 0), cos.shape[0] - S)
    return cos[start:start + S], sin[start:start + S]


def _rope_ref(q, k, cos, sin, interleaved=False):
    """The neox half-split rotation, or with ``interleaved`` the pairs
    (2j, 2j + 1) (``paddle_tpu/ops/paged_attention.py:rope_rotate``'s two
    styles), float32 math, in x's dtype."""
    def rot(x):
        xf = x.float()
        c = cos.float()[None, :, None, :]
        s = sin.float()[None, :, None, :]
        if interleaved:
            x1, x2 = xf[..., 0::2], xf[..., 1::2]
            return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                               dim=-1).reshape(xf.shape).to(x.dtype)
        half = xf.shape[-1] // 2
        x1, x2 = xf[..., :half], xf[..., half:]
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


def _rope_launch(fn, q, k, cos, sin, position_offset=None, sign=1.0,
                 ring=None, interleaved=False, **force):
    """K2 on CUDA tensors, counted on ``fn`` (the forward, the backward or
    the ring-mode wrapper); ``sign`` -1 rotates by -theta; ``ring`` (v,
    kbuf, vbuf): the ring mode (rotated k and v into the rings at the
    rows of ``position_offset``; no k output: returns (q, None));
    ``interleaved``: the pairs (2j, 2j + 1); ``force``: ``rope_plan``'s
    keywords."""
    name = fn.__name__
    B, S, H, D = q.shape
    KVH = k.shape[2]
    v, kbuf, vbuf = (None, None, None) if ring is None else ring
    heads = (q, k) if v is None else (q, k, v)
    if (k.shape[:2] != (B, S) or k.shape[3] != D or D % 2
            or (v is not None and v.shape != k.shape)):
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} (and v) must share B, S and an "
                         "even D")
    for x in heads:
        if x.stride(3) != 1 or (x.shape[2] > 1 and x.stride(2) != D):
            raise ValueError(f"{name}: each token's [heads, D] must be "
                             "contiguous")
    off = position_offset
    L = 0 if kbuf is None else kbuf.shape[1]
    if ring is not None:
        for t in (kbuf, vbuf):
            if (tuple(t.shape) != (B, L, KVH, D) or not t.is_contiguous()
                    or off is None or L < S):
                raise ValueError(f"{name}: rings must be contiguous [{B}, "
                                 f"L >= {S}, {KVH}, {D}] beside the device's "
                                 f"pos, got {tuple(t.shape)}")
    rows = S if off is None else cos.shape[0]
    for t in (cos, sin):
        if (t.dim() != 2 or t.shape[1] != D // 2 or t.shape[0] != rows
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name}: cos/sin must be contiguous float32 "
                             f"[{S if off is None else 'Smax'}, {D // 2}] "
                             f"on {q.device}")
    if off is not None and (off.dim() != 0 or off.dtype not in _OFFSET_BYTES
                            or off.device != q.device or rows < S):
        raise ValueError(f"{name}: position_offset must be a 0-d int32 or "
                         f"int64 tensor on {q.device} and the table at "
                         f"least {S} rows, got {off.dtype} on {off.device}, "
                         f"{rows} rows")
    dt, stream = _build.launch_args(name, *heads, *(ring or ()))
    oq = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    ok = (torch.empty((B, S, KVH, D), dtype=k.dtype, device=k.device)
          if ring is None else None)
    if B * S:
        # a size-1 dimension's stride is never stepped
        strides = [x.stride(i) if x.shape[i] > 1 else 0
                   for x in (q, k, v if v is not None else k) for i in (0, 1)]
        es = q.element_size()
        aligned = (all(t.data_ptr() % 16 == 0 for t in (
            *heads, oq, cos, sin, *((ok,) if ring is None else ring[1:])))
                   and all(st * es % 16 == 0 for st in strides))
        # in the ring mode v's heads are items of the same grid
        plan = rope_plan(B, S, H, KVH * (1 if ring is None else 2), D,
                         q.dtype, aligned, **force)

        def ptr(t):
            return None if t is None else t.data_ptr()

        with _build.device_guard(q):
            _build.check(_build.lib().ptt_rope(
                q.data_ptr(), k.data_ptr(), ptr(v), oq.data_ptr(), ptr(ok),
                ptr(kbuf), ptr(vbuf), cos.data_ptr(), sin.data_ptr(),
                ptr(off), 0 if off is None else _OFFSET_BYTES[off.dtype],
                rows, L, B, S, H, KVH, D, *strides, float(sign),
                int(plan.vec), int(interleaved), dt, stream), name)
        fn.launches += 1
    return oq, ok


@_build.kernel_op("rope(Tensor q, Tensor k, Tensor cos, Tensor sin, "
                  "Tensor? position_offset, bool interleaved) -> "
                  "(Tensor, Tensor)",
                  fake=lambda q, k, *_: (q.new_empty(q.shape),
                                         k.new_empty(k.shape)))
def _rope_fwd(q, k, cos, sin, position_offset, interleaved):
    if q.device.type == "cpu":
        return _rope_ref(q, k, *_window(cos, sin, q.shape[1],
                                        position_offset), interleaved)
    return _rope_launch(rope_fused, q, k, cos, sin, position_offset,
                        interleaved=interleaved)


def rope_bwd_fused(gq: torch.Tensor, gk: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor,
                   position_offset: Optional[torch.Tensor] = None,
                   interleaved: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rope backward (``_rope_bwd``): the cotangents of the rotated
    (q, k) rotated by -theta, i.e. K2 with ``-sin`` (a sign flag: no
    negated table is made); shapes, ``position_offset`` and
    ``interleaved`` as ``rope_fused``."""
    if gq.device.type == "cpu":
        c, s = _window(cos, sin, gq.shape[1], position_offset)
        return _rope_ref(gq, gk, c, -s, interleaved)
    return _rope_launch(rope_bwd_fused, gq.contiguous(), gk.contiguous(),
                        cos, sin, position_offset, sign=-1.0,
                        interleaved=interleaved)


def rope_ring_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, kbuf: torch.Tensor,
                    vbuf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K2's ring mode: q [B, S, H, D], k and v [B, S, KVH, D] (each head's
    [D] contiguous), cos/sin the whole [Smax, D/2] float32 table, the rings
    kbuf/vbuf [B, L, KVH, D] (contiguous, the dtype of q, k and v), pos a
    0-d int32 or int64 tensor on q's device.  Returns rotated q (rows
    ``clamp(wrap(pos, Smax), 0, Smax - S) + s`` of the table, as
    ``rope_fused``); writes rotated k into kbuf and v into vbuf at rows
    ``clamp(wrap(pos, L), 0, L - S) + s``, in place, in the same launch.
    An inference path: on CUDA a call that wants a gradient raises."""
    from .decode_attention import _ref_ring_write

    if q.device.type == "cpu":
        qr, kr = _rope_ref(q, k, *_window(cos, sin, q.shape[1], pos))
        _ref_ring_write(kbuf, vbuf, kr, v, pos)
        return qr
    if _build.wants_grad(q, k, v):
        raise NotImplementedError("rope_ring_fused: no backward (the static "
                                  "KV ring is an inference path)")
    return _rope_launch(rope_ring_fused, q, k, cos, sin, pos,
                        ring=(v, kbuf, vbuf))[0]


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos, sin, position_offset, interleaved):
        ctx.save_for_backward(cos, sin)
        ctx.position_offset = position_offset
        ctx.interleaved = interleaved
        return _rope_fwd(q, k, cos, sin, position_offset, interleaved)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        dq, dk = rope_bwd_fused(gq, gk, cos, sin, ctx.position_offset,
                                ctx.interleaved)
        return dq, dk, None, None, None, None


def rope_fused(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor,
               position_offset: Optional[torch.Tensor] = None,
               interleaved: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, S, H, D], k [B, S, KVH, D], cos/sin [S, D/2] float32 ->
    rotated (q, k), neox half-split (``interleaved``: the pairs (2j,
    2j + 1), blha_attention's ``use_neox_style=False``), float32 math, in
    q's dtype.  With
    ``position_offset`` (a 0-d int32 or int64 tensor on q's device)
    cos/sin are the whole [Smax, D/2] table and the rotation takes rows
    ``clamp(off, 0, Smax - S) + s`` (a negative off counted from the end
    first, as JAX indexes), read on the device.  q and k may be
    strided over B and S; each head's [D] must be contiguous.
    Differentiable in q and k."""
    if _build.wants_grad(q, k):
        return _Rope.apply(q, k, cos, sin, position_offset, interleaved)
    return _rope_fwd(q, k, cos, sin, position_offset, interleaved)


def _check_same(name, *tensors):
    a = tensors[0]
    for t in tensors:
        if t.shape != a.shape or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and of one "
                             f"shape, got {[tuple(x.shape) for x in tensors]}")


@_build.kernel_op("swiglu(Tensor a, Tensor b) -> Tensor",
                  fake=lambda a, b: a.new_empty(a.shape))
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
rope_ring_fused.launches = 0
swiglu_fused.launches = 0
swiglu_bwd_fused.launches = 0
