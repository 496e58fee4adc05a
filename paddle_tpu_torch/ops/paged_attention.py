"""Paged-KV serving attention — the port of ``paddle_tpu/ops/paged_attention.py``.

``blha_attention`` covers the reference's surface.  One step is

1. split the packed ``qkv`` buffer (an int32 one dequantized by
   ``qkv_out_scale``, then ``qkv_bias``);
2. token coordinates from ``cu_seqlens_q`` (row, local index, absolute
   position, validity), computed on the device once per step
   (``plan_step``) and shared by every layer;
3. rope at absolute positions, neox or interleaved — kernel K2
   (``ops/hopper/fused_ops.py``);
4. with ``cache_quant="dynamic"``, the refresh of the per-(row, KV head)
   scales of the rows in prefill, in place;
5. scatter this step's K/V into the block pools, in place (plain indexing,
   as the reference's ``.at[].set``), quantized to biased uint8 under the
   static or dynamic scales where ``cache_quant`` asks;
6. attention over the paged context — kernel K4, or over the int8 cache
   K4-int8 (``ops/hopper/paged_attention.py``), which read blocks through
   the block tables instead of gathering ``[B, KV, L, D]``; K4-int8 takes
   each row's own keys of this step at full precision from k and v; the
   pre-caches, where given, are a dense prefix of every row's keys that
   both kernels read in place (nothing of them is written to the pools);
   the additive ``mask`` (rows in prefill) and ``tgt_mask`` (the other
   rows) enter both kernels' scores (their masked instances);
7. the shift/smooth epilogue and the int8 output quantization.

Steps 1, 4, 5 and 7 are PyTorch ops on both devices: the reference
computes them in jnp, outside any Pallas kernel.  The caches and the
dynamic scales are updated in place where the JAX function returns new
ones.  The reference drops the K/V writes of invalid tokens, and of tokens
whose block-table entry is outside the pool (``mode="drop"`` at block id
NB), which ``index_put_`` cannot do.  The serving engine's caches hold one
block more than the pool, the drop block (``drop_block=True``, the
default): those writes land in block NB, which no block table names and
K4 never reads, and the step needs no host sync.  With
``drop_block=False`` the caches are the whole pool, as the reference's
public ``[NB, KV, bs, D]`` caches (``incubate.nn.functional.
block_multihead_attention``), and the write selects the kept tokens with
a data-dependent index (a host sync): a dropped token writes nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .hopper.fused_ops import rope_fused
from .hopper.paged_attention import (paged_attention, paged_attention_int8,
                                     paged_gather_kv)

__all__ = ["blha_attention", "plan_step", "StepPlan", "paged_gather_kv",
           "rope_rotate", "build_padding_metadata"]


class StepPlan(NamedTuple):
    """Token metadata of one serving step, shared by every layer: the rope
    rows at each token's absolute position, where each token's K/V is
    written, and its row, local index and validity (the dynamic scales'
    refresh and the quantized write read them).  ``plan_step`` builds it
    on the device with no host sync."""

    cos: Optional[torch.Tensor]     # [T, D/2] float32, None = no rope
    sin: Optional[torch.Tensor]
    blk: torch.Tensor               # [T] int64 block to write; NB = dropped
    slot: torch.Tensor              # [T] int64 position inside the block
    row: torch.Tensor               # [T] int64 the token's row b
    local: torch.Tensor             # [T] int64 its index inside the row
    valid: torch.Tensor             # [T] bool


def plan_step(cu_seqlens_q: torch.Tensor, seq_lens_decoder: torch.Tensor,
              seq_lens_this_time: torch.Tensor, block_tables: torch.Tensor,
              num_tokens: int, block_size: int, num_blocks: int,
              rope_emb: Optional[torch.Tensor] = None) -> StepPlan:
    """Token coordinates of the packed buffer (blha_attention steps 2, 3
    and 5's indices): token t belongs to row b = searchsorted(cu, t,
    right) - 1 and sits at absolute position dec[b] + (t - cu[b]); it is
    valid while t < cu[-1] and its local index < seq_lens_this_time[b].
    ``num_blocks`` is the pool without the drop block: an invalid token,
    or one whose block-table entry is outside the pool, writes to block
    ``num_blocks``, as the reference's drop target."""
    B, P = block_tables.shape
    dev = block_tables.device
    cu = cu_seqlens_q.long()
    tok = torch.arange(num_tokens, device=dev)
    b_idx = (torch.searchsorted(cu, tok, right=True) - 1).clamp(0, B - 1)
    local = tok - cu[b_idx]
    abs_pos = seq_lens_decoder.long()[b_idx] + local
    valid = (tok < cu[-1]) & (local < seq_lens_this_time.long()[b_idx])
    cos = sin = None
    if rope_emb is not None:
        rb = b_idx.clamp(max=rope_emb.shape[1] - 1)
        rp = abs_pos.clamp(0, rope_emb.shape[2] - 1)
        cos = rope_emb[0, rb, rp, 0]                       # [T, D/2]
        sin = rope_emb[1, rb, rp, 0]
    blk = block_tables.long()[b_idx, (abs_pos // block_size).clamp(0, P - 1)]
    blk = torch.where(valid & (blk >= 0) & (blk < num_blocks), blk,
                      num_blocks)
    return StepPlan(cos, sin, blk, abs_pos % block_size, b_idx, local, valid)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                neox: bool) -> torch.Tensor:
    """The shared rope rotation (reference ``:40-57``): x [..., H, D],
    cos/sin broadcastable to [..., H|1, D/2]; ``neox`` rotates the split
    halves, else the interleaved pairs (2j, 2j + 1); float32 math, in x's
    dtype.  A plain PyTorch helper: ``blha_attention`` rotates with K2."""
    c, s, xf = cos.float(), sin.float(), x.float()
    if neox:
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


def build_padding_metadata(seq_lens_this_time):
    """Host-side helper mirroring the reference's get_padding_offset
    (reference ``:84-101``): returns (padding_offsets, cum_offsets,
    cu_seqlens_q, cu_seqlens_k) as numpy."""
    lens = np.asarray(seq_lens_this_time).reshape(-1).astype(np.int64)
    bsz = lens.shape[0]
    max_len = int(lens.max()) if bsz else 0
    cum_offsets = np.zeros(bsz + 1, np.int32)
    cum_offsets[1:] = np.cumsum(max_len - lens)
    cu = np.zeros(bsz + 1, np.int32)
    cu[1:] = np.cumsum(lens)
    token_num = int(lens.sum())
    padding_offsets = np.zeros(token_num, np.int32)
    for i in range(bsz):
        padding_offsets[cu[i]:cu[i + 1]] = cum_offsets[i]
    return padding_offsets, cum_offsets[:-1], cu, cu.copy()


def _round(v: torch.Tensor, ties_away: bool) -> torch.Tensor:
    """Round to an integer: ties away from zero, or (``torch.round``) to
    even, as the reference's two modes."""
    if ties_away:
        return torch.trunc(v + torch.where(v >= 0, 0.5, -0.5))
    return torch.round(v)


def _quantize_u8(x, scale, round_ties_away: bool, max_bound: float,
                 min_bound: float) -> torch.Tensor:
    """float -> uint8 cache storage (reference ``:60-71``): round(x *
    scale) clipped to the bounds, biased by 128 (dequantized as (u8 - 128)
    * dequant scale)."""
    v = _round(x.float() * scale, round_ties_away)
    return (v.clamp(min_bound, max_bound) + 128.0).to(torch.uint8)


def _refresh_scales(k, v, plan: StepPlan, seq_lens_encoder, max_q_len,
                    max_bound, scales):
    """The dynamic refresh (reference ``:188-212``), IN PLACE: a row with
    ``seq_lens_encoder > 0`` takes q = max_bound / max(absmax, 1e-6) and d
    = max(absmax, 1e-6) / max_bound from the absmax of this step's valid
    tokens at a local index < ``max_q_len``; the other rows keep theirs.
    ``scales`` is (kq, vq, kd, vd), each float32 [B, KV]."""
    B, KV = scales[0].shape
    keep = (plan.valid & (plan.local < max_q_len))[:, None]
    pre = (seq_lens_encoder > 0)[:, None]
    for new, q_s, d_s in ((k, scales[0], scales[2]),
                          (v, scales[1], scales[3])):
        amax = torch.where(keep, new.float().abs().amax(dim=-1), 0.0)
        absmax = torch.zeros((B, KV), dtype=torch.float32,
                             device=new.device).scatter_reduce_(
            0, plan.row[:, None].expand(-1, KV), amax, "amax")
        m = absmax.clamp_min(1e-6)
        q_s.copy_(torch.where(pre, max_bound / m, q_s))
        d_s.copy_(torch.where(pre, m / max_bound, d_s))


def _aligned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous and 16-byte aligned (what the kernels'
    copies read): as it is where it already is, else a copy."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scatter_kv(key_cache, value_cache, k, v, plan: StepPlan,
                drop_block: bool = True):
    """Write each token's K/V [KV, D] at (plan.blk, :, plan.slot), in
    place.  Dropped tokens (plan.blk the pool's size) write into the drop
    block, or with ``drop_block=False`` nothing: only the kept tokens'
    rows are written (a data-dependent index)."""
    heads = torch.arange(key_cache.shape[1], device=plan.blk.device)[None, :]
    blk, slot = plan.blk, plan.slot
    if not drop_block:
        keep = (blk < key_cache.shape[0]).nonzero().squeeze(1)
        blk, slot, k, v = blk[keep], slot[keep], k[keep], v[keep]
    for cache, new in ((key_cache, k), (value_cache, v)):
        cache.index_put_((blk[:, None], heads, slot[:, None]),
                         new.to(cache.dtype))


def blha_attention(qkv: torch.Tensor, key_cache: torch.Tensor,
                   value_cache: torch.Tensor,
                   seq_lens_encoder: Optional[torch.Tensor],
                   seq_lens_decoder: torch.Tensor,
                   seq_lens_this_time: torch.Tensor,
                   cu_seqlens_q: torch.Tensor, block_tables: torch.Tensor, *,
                   num_heads: int, kv_num_heads: int, head_dim: int,
                   block_size: int, max_q_len: int,
                   use_neox_style: bool = True, cache_quant: str = "none",
                   round_ties_away: bool = True,
                   compute_dtype: Optional[torch.dtype] = None,
                   has_out_quant: bool = False,
                   qkv_out_scale: Optional[torch.Tensor] = None,
                   qkv_bias: Optional[torch.Tensor] = None,
                   rope_emb: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   tgt_mask: Optional[torch.Tensor] = None,
                   pre_key_cache: Optional[torch.Tensor] = None,
                   pre_value_cache: Optional[torch.Tensor] = None,
                   cache_k_quant_scales: Optional[torch.Tensor] = None,
                   cache_v_quant_scales: Optional[torch.Tensor] = None,
                   cache_k_dequant_scales: Optional[torch.Tensor] = None,
                   cache_v_dequant_scales: Optional[torch.Tensor] = None,
                   out_shift: Optional[torch.Tensor] = None,
                   out_smooth: Optional[torch.Tensor] = None,
                   out_scale: float = -1.0,
                   quant_max_bound: float = 127.0,
                   quant_min_bound: float = -127.0,
                   plan: Optional[StepPlan] = None,
                   drop_block: bool = True):
    """One serving attention step over the paged cache.

    qkv [T, (H+2*KV)*D] (int32 with ``qkv_out_scale`` [(H+2KV)*D]); caches
    [NB+1, KV, bs, D], updated IN PLACE, the last block being the drop
    block (module docstring), or with ``drop_block=False`` [NB, KV, bs, D],
    the whole pool, where a dropped token writes nothing; uint8 when
    ``cache_quant`` is "static" or "dynamic"; lengths [B] int32;
    ``cu_seqlens_q`` [B+1] and
    ``block_tables`` [B, P] int32; ``rope_emb`` [2, Br, Smax, 1, D/2]
    float32 (cos, sin).  ``seq_lens_encoder`` marks the rows whose dynamic
    scales refresh (> 0); None says that no row does (the serving
    engine's pure-decode loop).  The four float32 scale tensors are [KV]
    (static) or [B, KV] (dynamic, refreshed IN PLACE).  ``plan`` is this
    step's ``plan_step`` (built from ``rope_emb`` when None): a caller
    running several layers over one step builds it once.  Returns (out
    [T, H*D] in ``compute_dtype``, or int8 with ``has_out_quant``,
    key_cache, value_cache).  With ``out_shift``, ``out_smooth`` or
    ``has_out_quant`` the attention hands its float32 output to the
    epilogue, which rounds (or quantizes) once, as the reference does.
    ``pre_key_cache`` / ``pre_value_cache`` [B, KV, Lp, D], both or
    neither, put Lp keys in front of every row's context that all its
    queries see (``:255-260``, ``:274-279``): cast to the cache's dtype,
    or under cache quantization to the fresh keys' (full precision, not
    quantized).  ``mask`` [B, 1 | H, max_q_len, Lk] and ``tgt_mask`` [B,
    1 | H, 1, Lt] are additive (``:285-308``): ``mask`` on the rows with
    ``seq_lens_encoder > 0``, ``tgt_mask`` on the other rows with tokens;
    their key axis starts at the pre-caches' first column; they take
    ``seq_lens_encoder`` (ValueError without it) and are read in
    float32."""
    if (pre_key_cache is None) != (pre_value_cache is None):
        raise ValueError("blha_attention: pre_key_cache and pre_value_cache "
                         "come together")
    if cache_quant not in ("none", "static", "dynamic"):
        raise ValueError("cache_quant must be 'none', 'static' or 'dynamic'")
    quant = cache_quant != "none"
    scales = (cache_k_quant_scales, cache_v_quant_scales,
              cache_k_dequant_scales, cache_v_dequant_scales)
    if quant and (any(t is None for t in scales)
                  or key_cache.dtype != torch.uint8):
        raise ValueError(f"cache_quant={cache_quant!r} takes uint8 caches "
                         "and all four float32 scale tensors")
    H, KV, D = num_heads, kv_num_heads, head_dim
    T = qkv.shape[0]
    # the pool, without the drop block
    nb = key_cache.shape[0] - (1 if drop_block else 0)
    if plan is None:
        plan = plan_step(cu_seqlens_q, seq_lens_decoder, seq_lens_this_time,
                         block_tables, T, block_size, nb, rope_emb)
    cd = compute_dtype or (qkv.dtype if qkv.is_floating_point()
                           else torch.float32)
    if qkv_out_scale is not None:       # int32 qkv dequantized (:158-166)
        qkv_f = qkv.float() * qkv_out_scale[None, :]
    else:
        qkv_f = qkv.to(cd)
    if qkv_bias is not None:
        qkv_f = qkv_f + qkv_bias[None, :].to(qkv_f.dtype)
    q = qkv_f[:, :H * D].view(T, H, D)
    k = qkv_f[:, H * D:(H + KV) * D].view(T, KV, D)
    v = qkv_f[:, (H + KV) * D:].view(T, KV, D)
    if plan.cos is not None:
        q4, k4 = rope_fused(q[None], k[None], plan.cos, plan.sin,
                            interleaved=not use_neox_style)
        q, k = q4[0], k4[0]
    # the epilogue reads the attention's float32 value (:317-329); without
    # one the kernels round to q's dtype themselves
    epilogue = (out_shift is not None or out_smooth is not None
                or has_out_quant)
    od = torch.float32 if epilogue else None
    # the pre-caches in the cache's dtype, or the fresh keys' under quant
    pdt = k.dtype if quant else key_cache.dtype
    extra = ({} if pre_key_cache is None else
             dict(pre_key=_aligned(pre_key_cache, pdt),
                  pre_value=_aligned(pre_value_cache, pdt)))
    # the masks in float32, with the rows they reach (``seq_lens_encoder``)
    if mask is not None or tgt_mask is not None:
        extra.update(seq_lens_encoder=seq_lens_encoder, **{
            n: None if m is None else _aligned(m, torch.float32)
            for n, m in (("mask", mask), ("tgt_mask", tgt_mask))})
    if not quant:
        _scatter_kv(key_cache, value_cache, k, v, plan, drop_block)
        out = paged_attention(q.contiguous(), key_cache[:nb],
                              value_cache[:nb], seq_lens_decoder,
                              seq_lens_this_time, cu_seqlens_q,
                              block_tables, max_q_len, out_dtype=od, **extra)
    else:
        if cache_quant == "dynamic" and seq_lens_encoder is not None:
            # before the write: this step's tokens take the new scales
            _refresh_scales(k, v, plan, seq_lens_encoder, max_q_len,
                            quant_max_bound, scales)
        if cache_quant == "static":
            ksc, vsc = scales[0][None, :, None], scales[1][None, :, None]
        else:
            ksc = scales[0][plan.row][:, :, None]          # [T, KV, 1]
            vsc = scales[1][plan.row][:, :, None]
        _scatter_kv(key_cache, value_cache,
                    _quantize_u8(k, ksc, round_ties_away, quant_max_bound,
                                 quant_min_bound),
                    _quantize_u8(v, vsc, round_ties_away, quant_max_bound,
                                 quant_min_bound), plan, drop_block)
        out = paged_attention_int8(
            q.contiguous(), k, v, key_cache[:nb], value_cache[:nb],
            scales[2], scales[3], seq_lens_decoder, seq_lens_this_time,
            cu_seqlens_q, block_tables, max_q_len, out_dtype=od, **extra)
    out = out.reshape(T, H * D)
    # the elementwise epilogue (:317-329): shift, then smooth, then the
    # int8 output quantization
    if out_shift is not None:
        out = out + out_shift[None, :].to(out.dtype)
    if out_smooth is not None:
        out = out * out_smooth[None, :].to(out.dtype)
    if has_out_quant:
        vq = _round(out.float() * out_scale * quant_max_bound,
                    round_ties_away)
        return (vq.clamp(quant_min_bound, quant_max_bound).to(torch.int8),
                key_cache, value_cache)
    return out.to(cd), key_cache, value_cache
