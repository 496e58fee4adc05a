"""The port of ``paddle_tpu/incubate/nn/functional/__init__.py``'s paged
serving attention: ``block_multihead_attention`` (reference ``:859-978``)
and ``blha_get_max_len`` (``:698-710``), over plain tensors.

``block_multihead_attention`` is one eager call of
``ops.paged_attention.blha_attention`` on the reference's public caches
``[NB, KV, bs, D]``.  They have no drop block, so it runs with
``drop_block=False``: a token the reference drops (past ``cu_seqlens_q[-1]``,
past its row's length, or whose block-table entry is outside the pool)
writes nothing, and the pools are written in place, never copied.  The
padded query length is ``max(seq_lens_this_time)`` read on the host and
bucketed to the next power of two, as the reference does, so the call
cannot be captured into a CUDA graph; ``inference.serving.ServingEngine``
is the path for serving from graphs.  On the card a call launches K2 (the
rope) and K4, or K4-int8 over uint8 caches (their masked instances under
``mask`` / ``tgt_mask``); on the CPU it runs their plain versions.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....ops.paged_attention import blha_attention

__all__ = ["block_multihead_attention", "blha_get_max_len"]

# compute_dtype names (the reference's :944-946)
_DTYPES = {"fp16": torch.float16, "float16": torch.float16,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _on(x, device, dtype=None) -> Optional[torch.Tensor]:
    """``x`` (a tensor or array-like) as a tensor on ``device``, in
    ``dtype`` where given; None stays None."""
    if x is None:
        return None
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def block_multihead_attention(
        qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder,
        seq_lens_this_time, padding_offsets, cum_offsets, cu_seqlens_q,
        cu_seqlens_k, block_tables, pre_key_cache=None, pre_value_cache=None,
        cache_k_quant_scales=None, cache_v_quant_scales=None,
        cache_k_dequant_scales=None, cache_v_dequant_scales=None,
        qkv_out_scale=None, qkv_bias=None, out_shift=None, out_smooth=None,
        max_enc_len_this_time=None, max_dec_len_this_time=None,
        rope_emb=None, mask=None, tgt_mask=None, max_seq_len=-1,
        block_size=64, use_neox_style=False, use_dynamic_cachekv_quant=False,
        quant_round_type=1, quant_max_bound=127.0, quant_min_bound=-127.0,
        out_scale=-1.0, compute_dtype="default"):
    """One paged-KV serving attention step (the reference's signature).

    qkv [T, (H + 2 KV) D] (int32 with ``qkv_out_scale``); key_cache /
    value_cache [NB, KV, block_size, D] (uint8 under cache quantization),
    written IN PLACE; seq_lens_* [B]; cu_seqlens_q [B + 1]; block_tables
    [B, P] (-1 for a free slot).  H is ``qkv.shape[1] // D - 2 KV``.  The
    cache quantization is "dynamic" with ``use_dynamic_cachekv_quant`` and
    scales given (the four scale tensors [B, KV] are refreshed IN PLACE on
    the rows in prefill, so each must be a ``torch.Tensor``: TypeError
    otherwise), "static" with scales [KV] given, else none.
    ``compute_dtype`` "default" is qkv's dtype (int32 qkv needs one named:
    ValueError).  ``padding_offsets``, ``cum_offsets``, ``cu_seqlens_k``,
    ``max_enc_len_this_time``, ``max_dec_len_this_time`` and
    ``max_seq_len`` are taken and unused, as the reference's.  Returns
    (out [T, H D], qkv, key_cache, value_cache).  Raises ValueError for a
    ``block_size`` other than the caches' block axis, and inside a CUDA
    graph's capture."""
    kc, vc = key_cache, value_cache
    KV, bs, D = kc.shape[1], kc.shape[2], kc.shape[3]
    if int(bs) != int(block_size):
        raise ValueError(f"block_size={block_size} does not match key_cache "
                         f"block axis ({bs})")
    H = qkv.shape[1] // D - 2 * KV
    if _capturing():
        raise ValueError(
            "block_multihead_attention reads max(seq_lens_this_time) on the "
            "HOST to pick the padded-query bucket, so it cannot be captured "
            "into a CUDA graph: call it eagerly, or serve through "
            "ServingEngine, which captures per-bucket programs with a static "
            "max_q_len")
    dev = qkv.device
    ints = [_on(x, dev, torch.int32).reshape(-1).contiguous()
            for x in (seq_lens_encoder, seq_lens_decoder, seq_lens_this_time,
                      cu_seqlens_q)]
    lens = ints[2]
    max_q_len = int(lens.max()) if lens.numel() else 1
    # the padded query length bucketed to the next power of two (the
    # reference's :920-925)
    max_q_len = 1 << max(max_q_len - 1, 0).bit_length()

    scales = (cache_k_quant_scales, cache_v_quant_scales,
              cache_k_dequant_scales, cache_v_dequant_scales)
    if use_dynamic_cachekv_quant and cache_k_quant_scales is not None:
        cache_quant = "dynamic"
        if not all(isinstance(t, torch.Tensor) for t in scales):
            raise TypeError(
                "use_dynamic_cachekv_quant=True refreshes the scale tensors "
                "IN PLACE (reference contract): pass torch.Tensors, not raw "
                "arrays, or the updated scales would be lost")
    elif (cache_k_quant_scales is not None
          or cache_k_dequant_scales is not None):
        cache_quant = "static"
        scales = tuple(_on(t, dev, torch.float32) for t in scales)
    else:
        cache_quant = "none"

    if compute_dtype == "default":
        if not qkv.is_floating_point():
            raise ValueError(
                "int32 qkv needs an explicit compute_dtype (e.g. 'fp16')")
        cdt = qkv.dtype
    else:
        cdt = _DTYPES[compute_dtype]

    out, _, _ = blha_attention(
        qkv, kc, vc, *ints, _on(block_tables, dev, torch.int32).contiguous(),
        num_heads=int(H), kv_num_heads=int(KV), head_dim=int(D),
        block_size=int(block_size), max_q_len=max_q_len,
        use_neox_style=bool(use_neox_style), cache_quant=cache_quant,
        round_ties_away=quant_round_type == 1, compute_dtype=cdt,
        has_out_quant=out_scale > 0,
        qkv_out_scale=_on(qkv_out_scale, dev), qkv_bias=_on(qkv_bias, dev),
        rope_emb=_on(rope_emb, dev, torch.float32),
        mask=_on(mask, dev), tgt_mask=_on(tgt_mask, dev),
        pre_key_cache=_on(pre_key_cache, dev),
        pre_value_cache=_on(pre_value_cache, dev),
        cache_k_quant_scales=scales[0], cache_v_quant_scales=scales[1],
        cache_k_dequant_scales=scales[2], cache_v_dequant_scales=scales[3],
        out_shift=_on(out_shift, dev), out_smooth=_on(out_smooth, dev),
        out_scale=float(out_scale), quant_max_bound=float(quant_max_bound),
        quant_min_bound=float(quant_min_bound), drop_block=False)
    return out, qkv, key_cache, value_cache


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size):
    """(max encoder length, max decoder length) over the first
    ``batch_size`` rows, each an int32 [1] tensor on its input's device
    (the lengths may be padded past the live batch)."""
    b = int(torch.as_tensor(batch_size).reshape(-1)[0])

    def mx(t):
        return torch.as_tensor(t).reshape(-1)[:b].to(torch.int32).max(
        ).reshape(1)

    return mx(seq_lens_encoder), mx(seq_lens_decoder)
