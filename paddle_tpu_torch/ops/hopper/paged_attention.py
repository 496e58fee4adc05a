"""Paged-KV attention core — Hopper kernel K4 (``csrc/paged_attention.cu``).

The attention of ``paddle_tpu/ops/paged_attention.py:blha_attention``
(steps 6-8, ``:237-316``), which the JAX package leaves to XLA and computes
by gathering every sequence's whole context.  The kernel reads keys and
values through the block tables instead (online softmax, float32 state;
see the source's note).  It is bound on the H100 by the bytes of context
it reads.

``paged_attention`` runs the plain version (``_paged_attention_ref``, the
reference's gather + padded-batch attention transcribed) only for CPU
tensors.  For CUDA tensors it launches the kernel or raises; ``launches``
counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_gather_kv"]


def paged_gather_kv(cache: torch.Tensor, block_tables: torch.Tensor
                    ) -> torch.Tensor:
    """cache [NB, KV, bs, D] + block_tables [B, P] -> [B, KV, P*bs, D].
    Out-of-range block ids (free slots marked -1) gather zeros."""
    nb = cache.shape[0]
    bt = block_tables.long()
    ok = (bt >= 0) & (bt < nb)
    g = cache[bt.clamp(0, nb - 1)]                       # [B, P, KV, bs, D]
    g = torch.where(ok[:, :, None, None, None], g,
                    torch.zeros((), dtype=g.dtype, device=g.device))
    B, P, KV, bs, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, KV, P * bs, D)


def _paged_attention_ref(q, key_cache, value_cache, seq_lens_decoder,
                         seq_lens_this_time, cu_seqlens_q, block_tables,
                         max_q_len):
    """blha_attention steps 6-8: gather each row's context, padded-batch
    attention with float32 softmax, gather back to the packed buffer."""
    T, H, D = q.shape
    KV = key_cache.shape[1]
    B = block_tables.shape[0]
    dev = q.device
    cu = cu_seqlens_q.long()
    tok = torch.arange(T, device=dev)
    b_idx = (torch.searchsorted(cu, tok, right=True) - 1).clamp(0, B - 1)
    local = tok - cu[b_idx]
    valid = (tok < cu[-1]) & (local < seq_lens_this_time.long()[b_idx])
    k_all = paged_gather_kv(key_cache, block_tables)     # [B, KV, L, D]
    v_all = paged_gather_kv(value_cache, block_tables)
    L = k_all.shape[2]
    S = int(max_q_len)
    # row B / column S are the drop targets of the reference's mode="drop"
    bs_idx = torch.where(valid, b_idx, B)
    lc_idx = torch.where(valid & (local < S), local, S)
    q_pad = torch.zeros((B + 1, S + 1, H, D), dtype=q.dtype, device=dev)
    q_pad[bs_idx, lc_idx] = q
    qg = q_pad[:B, :S].reshape(B, S, KV, H // KV, D).float()
    logits = torch.einsum("bskgd,bkld->bkgsl", qg, k_all.float()) / (D ** 0.5)
    qpos = (seq_lens_decoder.long()[:, None]
            + torch.arange(S, device=dev)[None, :])       # [B, S]
    vis = torch.arange(L, device=dev)[None, None, :] <= qpos[:, :, None]
    logits = torch.where(vis[:, None, None], logits,
                         torch.tensor(-1e30, dtype=torch.float32, device=dev))
    p = torch.softmax(logits, dim=-1)
    out_pad = torch.einsum("bkgsl,bkld->bskgd", p, v_all.float())
    out_full = torch.zeros((B + 1, S + 1, H, D), dtype=torch.float32,
                           device=dev)
    out_full[:B, :S] = out_pad.reshape(B, S, H, D)
    return out_full[bs_idx, lc_idx].to(q.dtype)          # [T, H, D]


def _check(name, q, key_cache, value_cache, ints, block_tables):
    T, H, D = q.shape
    NB, KV, _, Dc = key_cache.shape
    if value_cache.shape != key_cache.shape or Dc != D or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit caches "
                         f"{tuple(key_cache.shape)}/{tuple(value_cache.shape)}")
    if D > 256 or D % 8:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 8 "
                         "and <= 256")
    for t in (q, key_cache, value_cache, *ints, block_tables):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in (key_cache, value_cache):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: caches must be 16-byte aligned (the "
                             "kernel reads them in 16-byte vectors)")
    for t in (*ints, block_tables):
        if t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{name}: lengths, cu_seqlens and block tables "
                             f"must be int32 on {q.device}")


def paged_attention(q: torch.Tensor, key_cache: torch.Tensor,
                    value_cache: torch.Tensor,
                    seq_lens_decoder: torch.Tensor,
                    seq_lens_this_time: torch.Tensor,
                    cu_seqlens_q: torch.Tensor, block_tables: torch.Tensor,
                    max_q_len: int) -> torch.Tensor:
    """q [T, H, D] (after rope), caches [NB, KV, bs, D] already holding this
    step's keys and values, seq_lens_decoder/this_time [B], cu_seqlens_q
    [B+1], block_tables [B, P] -> attention output [T, H, D] in q's dtype.
    Token i of row b sits at ``dec_b + (i - cu_b)`` and attends its row's
    keys up to that position; tokens past ``cu[-1]``, past their row's
    length, or at a local index >= ``max_q_len`` give zeros."""
    if q.device.type == "cpu":
        return _paged_attention_ref(q, key_cache, value_cache,
                                    seq_lens_decoder, seq_lens_this_time,
                                    cu_seqlens_q, block_tables, max_q_len)
    name = "paged_attention"
    ints = (seq_lens_decoder, seq_lens_this_time, cu_seqlens_q)
    _check(name, q, key_cache, value_cache, ints, block_tables)
    dt, stream = _build.launch_args(name, q, key_cache, value_cache)
    T, H, D = q.shape
    NB, KV, bs, _ = key_cache.shape
    B, P = block_tables.shape
    out = torch.empty_like(q)
    if T:
        with _build.device_guard(q):
            _build.check(_build.lib().ptt_paged_attention(
                q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
                out.data_ptr(), seq_lens_decoder.data_ptr(),
                seq_lens_this_time.data_ptr(), cu_seqlens_q.data_ptr(),
                block_tables.data_ptr(), T, B, P, NB, H, KV, D, bs,
                int(max_q_len), 1.0 / math.sqrt(D), dt, stream), name)
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
