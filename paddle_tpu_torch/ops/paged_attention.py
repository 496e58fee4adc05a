"""Paged-KV serving attention — the port of ``paddle_tpu/ops/paged_attention.py``.

The surface the serving engine uses: ``cache_quant="none"``, neox rope, no
pre-caches, masks, qkv dequant or output quantization.  One step is

1. split the packed ``qkv`` buffer;
2. token coordinates from ``cu_seqlens_q`` (row, local index, absolute
   position, validity), computed on the device once per step
   (``plan_step``) and shared by every layer;
3. rope at absolute positions — kernel K2 (``ops/hopper/fused_ops.py``);
4. scatter this step's K/V into the block pools, in place (plain indexing,
   as the reference's ``.at[].set``);
5. attention over the paged context — kernel K4
   (``ops/hopper/paged_attention.py``), which reads blocks through the
   block tables instead of gathering ``[B, KV, L, D]``.

The caches are updated in place where the JAX function returns new ones.
They hold one block more than the pool, the drop block: the reference drops
the K/V writes of invalid tokens (``mode="drop"`` at block id NB), which
``index_put_`` cannot do, so here they land in block NB, which no block
table names and K4 never reads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .hopper.fused_ops import rope_fused
from .hopper.paged_attention import paged_attention, paged_gather_kv

__all__ = ["blha_attention", "plan_step", "StepPlan", "paged_gather_kv"]


class StepPlan(NamedTuple):
    """Token metadata of one serving step, shared by every layer: the rope
    rows at each token's absolute position and where each token's K/V is
    written.  ``plan_step`` builds it on the device with no host sync."""

    cos: Optional[torch.Tensor]     # [T, D/2] float32, None = no rope
    sin: Optional[torch.Tensor]
    blk: torch.Tensor               # [T] int64 block to write; NB = dropped
    slot: torch.Tensor              # [T] int64 position inside the block


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
    return StepPlan(cos, sin, blk, abs_pos % block_size)


def _scatter_kv(key_cache, value_cache, k, v, plan: StepPlan):
    """Write each token's K/V [KV, D] at (plan.blk, :, plan.slot), in
    place; dropped tokens write into the drop block."""
    heads = torch.arange(key_cache.shape[1], device=plan.blk.device)[None, :]
    for cache, new in ((key_cache, k), (value_cache, v)):
        cache.index_put_((plan.blk[:, None], heads, plan.slot[:, None]),
                         new.to(cache.dtype))


def blha_attention(qkv: torch.Tensor, key_cache: torch.Tensor,
                   value_cache: torch.Tensor,
                   seq_lens_encoder: torch.Tensor,
                   seq_lens_decoder: torch.Tensor,
                   seq_lens_this_time: torch.Tensor,
                   cu_seqlens_q: torch.Tensor, block_tables: torch.Tensor, *,
                   num_heads: int, kv_num_heads: int, head_dim: int,
                   block_size: int, max_q_len: int,
                   use_neox_style: bool = True, cache_quant: str = "none",
                   compute_dtype: Optional[torch.dtype] = None,
                   rope_emb: Optional[torch.Tensor] = None,
                   plan: Optional[StepPlan] = None):
    """One serving attention step over the paged cache.

    qkv [T, (H+2*KV)*D]; caches [NB+1, KV, bs, D], updated IN PLACE, the
    last block being the drop block (module docstring); lengths
    [B] int32 (``seq_lens_encoder`` is accepted for the reference's
    signature: with ``cache_quant="none"`` it changes nothing);
    ``cu_seqlens_q`` [B+1] and ``block_tables`` [B, P] int32; ``rope_emb``
    [2, Br, Smax, 1, D/2] float32 (cos, sin).  ``plan`` is this step's
    ``plan_step`` (built from ``rope_emb`` when None): a caller running
    several layers over one step builds it once.  Returns
    (out [T, H*D], key_cache, value_cache)."""
    if cache_quant != "none" or not use_neox_style:
        raise NotImplementedError(
            "the port's blha_attention covers cache_quant='none' with neox "
            "rope; int8 caches and interleaved rope come with a later slice")
    H, KV, D = num_heads, kv_num_heads, head_dim
    T = qkv.shape[0]
    nb = key_cache.shape[0] - 1             # the pool, without the drop block
    if plan is None:
        plan = plan_step(cu_seqlens_q, seq_lens_decoder, seq_lens_this_time,
                         block_tables, T, block_size, nb, rope_emb)
    qkv_f = qkv.to(compute_dtype or qkv.dtype)
    q = qkv_f[:, :H * D].view(T, H, D)
    k = qkv_f[:, H * D:(H + KV) * D].view(T, KV, D)
    v = qkv_f[:, (H + KV) * D:].view(T, KV, D)
    if plan.cos is not None:
        q4, k4 = rope_fused(q[None], k[None], plan.cos, plan.sin)
        q, k = q4[0], k4[0]
    _scatter_kv(key_cache, value_cache, k, v, plan)
    out = paged_attention(q.contiguous(), key_cache[:nb], value_cache[:nb],
                          seq_lens_decoder, seq_lens_this_time, cu_seqlens_q,
                          block_tables, max_q_len)
    return out.reshape(T, H * D), key_cache, value_cache
