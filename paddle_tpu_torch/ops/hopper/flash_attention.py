"""Flash attention forward — Hopper kernel B1 (``csrc/flash_attention.cu``).

Port of the forward half of ``paddle_tpu/ops/pallas/flash_attention.py``:
``flash_attention_fused`` replaces ``_pallas_fwd`` (``_fwd_kernel``).  It
computes tiled online-softmax attention with float32 accumulators and a
per-row float32 logsumexp, causal with FlashAttention-2's bottom-right
alignment, GQA by reading KV head ``h // (H / KVH)``.  Bound on the H100 by
operations at prefill lengths (the kernel is SIMT float32, see the source's
note) and by bytes for a single query row.

Beside the reference it takes a query offset: causal row ``i`` sees the
columns ``<= i + q_offset``, where ``q_offset`` is ``Sk - Sq`` by default
(the reference's rule) or a 0-d int32 tensor on the device, read by the
kernel with no host sync — the static KV ring's prefill, whose queries sit
at ``pos .. pos + Sq - 1`` of a ring of ``Sk`` rows.  Rows that see no key
give zeros and a logsumexp of -1e30, as ``_ref_fwd_impl`` and the Pallas
kernel do.

``flash_attention_fused`` runs the plain version (``_ref_fwd_impl``, the
reference's jnp fallback transcribed, in float32) only for CPU tensors.
For CUDA tensors it launches the kernel or raises; ``launches`` counts
kernel launches.  ``block_fwd`` and ``flash_attention_fwd`` are the
reference's two entries over it.  The backward (B8) comes with training.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from . import _build

__all__ = ["flash_attention_fused", "block_fwd", "flash_attention_fwd"]

NEG_INF = -1e30

Offset = Optional[Union[int, torch.Tensor]]


def _ref_fwd_impl(q, k, v, causal: bool, scale: float,
                  q_offset: Offset = None):
    """[BH, Sq, D] x [BH, Sk, D] -> (out [BH, Sq, D] in q's dtype, lse
    [BH, Sq] float32), float32 scores and softmax.  Causal row ``i`` sees
    the columns ``<= i + q_offset`` (default ``Sk - Sq``); rows that see no
    key give zeros."""
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    row_valid = None
    if causal:
        sq, sk = logits.shape[1], logits.shape[2]
        off = sk - sq if q_offset is None else q_offset
        rows = torch.arange(sq, device=q.device)[:, None] + off
        mask = torch.arange(sk, device=q.device)[None, :] <= rows
        logits = torch.where(mask, logits, NEG_INF)
        row_valid = mask.any(dim=-1)                       # [Sq]
    m = logits.amax(dim=-1, keepdim=True)
    p_un = torch.exp(logits - m)
    l = p_un.sum(dim=-1, keepdim=True)  # noqa: E741
    lse = (m + torch.log(l))[..., 0]
    p = p_un / l
    if row_valid is not None:
        p = torch.where(row_valid[None, :, None], p, 0.0)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype), lse


def _plain_bshd(q, k, v, causal, scale, q_offset):
    """The plain version over the [B, S, H, D] layout: heads folded into
    the batch, KV heads repeated for GQA -> (out [B, Sq, H, D], lse
    [B, H, Sq])."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    rep = H // KVH
    qb = q.permute(0, 2, 1, 3).reshape(B * H, Sq, D)
    kb = k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(
        B * H, Sk, D)
    vb = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).reshape(
        B * H, Sk, D)
    out, lse = _ref_fwd_impl(qb, kb, vb, causal, scale, q_offset)
    return (out.reshape(B, H, Sq, D).permute(0, 2, 1, 3).contiguous(),
            lse.reshape(B, H, Sq))


def _check(name, q, k, v, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B, Sq, H, D] and k = v [B, Sk, KVH, D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if D % 16 or D > 256:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 16 "
                         "and <= 256")
    es = q.element_size()
    for t in (q, k, v):
        # each row [D] contiguous and 16-byte aligned: the kernel reads
        # rows in 16-byte vectors
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                (t.stride(i) * es) % 16 for i in range(3)):
            raise ValueError(f"{name}: each head row must be contiguous and "
                             "16-byte aligned")
    if isinstance(q_offset, torch.Tensor) and (
            q_offset.dtype != torch.int32 or q_offset.numel() != 1
            or q_offset.device != q.device):
        raise ValueError(f"{name}: a tensor q_offset must be one int32 on "
                         f"{q.device}")


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: Optional[float] = None,
                          q_offset: Offset = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Sq, H, D], k/v [B, Sk, KVH, D] (paddle's layout; any strides
    with contiguous 16-byte-aligned head rows) -> (out [B, Sq, H, D] in q's
    dtype, lse [B, H, Sq] float32).  ``scale`` defaults to 1/sqrt(D);
    ``q_offset`` (causal only) is an int or a 0-d int32 device tensor,
    ``Sk - Sq`` when None."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return _plain_bshd(q, k, v, causal, scale, q_offset)
    name = "flash_attention_fused"
    _check(name, q, k, v, q_offset)
    dt, stream = _build.launch_args(name, q, k, v)
    B, Sq, H, _ = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    off_ptr, off = None, Sk - Sq
    if isinstance(q_offset, torch.Tensor):
        off_ptr = q_offset.data_ptr()
    elif q_offset is not None:
        off = int(q_offset)
    if B * Sq * H:
        with _build.device_guard(q):
            _build.check(_build.lib().ptt_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), off_ptr, B, Sq, Sk, H, KVH, D,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                int(bool(causal)), off, scale, dt, stream), name)
        flash_attention_fused.launches += 1
    return out, lse


flash_attention_fused.launches = 0


def block_fwd(qb, kb, vb, causal: bool, scale: float, kv_rep: int = 1,
              q_offset: Offset = None):
    """One attention block, the reference's dispatch point:
    qb [BH, Sq, D], kb/vb [BHk, Sk, D] with BH = BHk * kv_rep (query batch
    b reads key batch b // kv_rep) -> (o [BH, Sq, D], lse [BH, Sq] f32)."""
    bh, sq, d = qb.shape
    bhk, sk, _ = kb.shape
    # [BH, S, D] as [BHk, S, kv_rep, D] views: query head r of group g is
    # batch g * kv_rep + r, and the group's single KV head is head 0
    q4 = qb.view(bhk, kv_rep, sq, d).permute(0, 2, 1, 3)
    k4 = kb.view(bhk, 1, sk, d).permute(0, 2, 1, 3)
    v4 = vb.view(bhk, 1, sk, d).permute(0, 2, 1, 3)
    o4, lse = flash_attention_fused(q4, k4, v4, causal, scale, q_offset)
    return (o4.permute(0, 2, 1, 3).reshape(bh, sq, d),
            lse.reshape(bh, sq))


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        q_offset: Offset = None) -> torch.Tensor:
    """Public entry: q [B, Sq, H, D], k/v [B, Sk, KVH, D] -> [B, Sq, H, D].
    K/V are never repeated to the query head count (the kernel indexes the
    group's KV head)."""
    return flash_attention_fused(q, k, v, causal, scale, q_offset)[0]
