"""Flash attention — Hopper kernels B1 (forward, ``csrc/flash_attention.cu``)
and B8 (backward, ``csrc/flash_attention_bwd.cu``).

Port of ``paddle_tpu/ops/pallas/flash_attention.py``:
``flash_attention_fused`` replaces ``_pallas_fwd`` (``_fwd_kernel``) and
``flash_attention_bwd_fused`` replaces ``_pallas_bwd`` (``_dq_kernel`` and
``_dkv_kernel``).  The forward computes tiled online-softmax attention
with float32 accumulators and a per-row float32 logsumexp, causal with
FlashAttention-2's bottom-right alignment, GQA by reading KV head
``h // (H / KVH)``.  bfloat16 runs on the tensor cores (wgmma, bf16
products with float32 accumulation), float32 on the SIMT instances (the
port pins TF32 off); the tile pair comes from the explicit (dtype, D, tile)
table of ``autotune.py`` and a pair with no compiled instance raises.
Bound on the H100 by operations at prefill lengths and by bytes for a
single query row.

Beside the reference it takes a query offset: causal row ``i`` sees the
columns ``<= i + q_offset``, where ``q_offset`` is ``Sk - Sq`` by default
(the reference's rule) or a 0-d int32 tensor on the device, read by the
kernel with no host sync — the static KV ring's prefill, whose queries sit
at ``pos .. pos + Sq - 1`` of a ring of ``Sk`` rows.  Rows that see no key
give zeros and a logsumexp of -1e30, as ``_ref_fwd_impl`` and the Pallas
kernel do.

The backward recomputes the probabilities from the saved logsumexp
(FlashAttention-2): dQ, dK and dV with float32 accumulation, the causal
rule and the tile skipping of the forward, zero gradients for rows that see
no key, and for GQA dK/dV summed over each KV head's group in float32
before one cast (K and V are never repeated).  In bfloat16, dQ is summed
with float32 atomics, so its rounding may vary from run to run; float32 is
deterministic.

Head dims: any D.  On CUDA a D that is not a multiple of 8 is zero-padded
to the next one in the wrapper (q, k, v, and for the backward out and g;
exact: QK^T and the logsumexp do not change, the padded columns of out,
dQ, dK and dV are 0 and are sliced off; the scale stays 1/sqrt of the true
D).  Up to 256 bfloat16 runs the tensor-core instance of D's class
(columns past D zero-filled); past 256 both dtypes run the SIMT instances
with the class-512 tiles, which hold rows whole up to
``autotune.MAX_HEAD_DIM`` (512) and past it stream the head dim through
shared memory in chunks, each block writing one slice of at most 512
output columns (Queue C8).

``flash_attention_fused`` and ``flash_attention_bwd_fused`` run their plain
versions (``_ref_fwd_impl`` / ``_ref_bwd_impl``, the reference's jnp
fallbacks transcribed, in float32) only for CPU tensors.  For CUDA tensors
they launch the kernels or raise; ``launches`` counts the calls that
launch (a call may be several CUDA kernels).  The forward is the
``torch.library`` op ``paddle_tpu_torch::flash_attention``: every
address, alignment check and tile choice is read in its real
implementation, so ``torch.export`` traces it through its fake one
(output shapes only) and keeps the call.
``block_fwd`` / ``block_bwd`` and ``flash_attention_fwd`` are the
reference's entries over them; ``flash_attention_fwd`` is differentiable
(a ``torch.autograd.Function`` saving q, k, v, out and lse, as
``_flash_core_fwd``) for the default causal offset.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from . import _build, autotune

__all__ = ["flash_attention_fused", "flash_attention_bwd_fused", "block_fwd",
           "block_bwd", "flash_attention_fwd"]

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


def _ref_bwd_impl(q, k, v, o, lse, g, causal: bool, scale: float):
    """The reference's jnp backward from the saved lse, [BH, S, D] blocks
    -> float32 (dq, dk, dv); rows that see no key give zeros."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    row_valid = None
    if causal:
        sq, sk = s.shape[1], s.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, NEG_INF)
        row_valid = mask.any(dim=-1)
    p = torch.exp(s - lse[..., None])
    if row_valid is not None:
        p = torch.where(row_valid[None, :, None], p, 0.0)
    gf = g.float()
    delta = torch.sum(gf * o.float(), dim=-1)                # [BH, Sq]
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dq, dk, dv


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


def _plain_bwd_bshd(q, k, v, o, lse, g, causal, scale):
    """The plain backward over the [B, S, H, D] layout: heads folded into
    the batch, KV heads repeated for GQA and their gradients summed over
    each group in float32 -> (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    rep = H // KVH

    def fold(x, r=1):
        x = x.permute(0, 2, 1, 3)
        if r > 1:
            x = x.repeat_interleave(r, dim=1)
        return x.reshape(-1, x.shape[2], D)

    dq, dk, dv = _ref_bwd_impl(
        fold(q), fold(k, rep), fold(v, rep), fold(o), lse.reshape(B * H, Sq),
        fold(g), causal, scale)

    def unfold(x, heads, S, dt):
        x = x.reshape(B, heads, -1, S, D).sum(dim=2)
        return x.permute(0, 2, 1, 3).contiguous().to(dt)

    return (unfold(dq, H, Sq, q.dtype), unfold(dk, KVH, Sk, k.dtype),
            unfold(dv, KVH, Sk, v.dtype))


def _check(name, q, k, v, q_offset):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B, Sq, H, D] and k = v [B, Sk, KVH, D] "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if D <= 0:
        raise ValueError(f"{name}: head_dim {D}")
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


def _pad8(*tensors):
    """The tensors zero-padded along D to the next multiple of 8 (the
    instances' unit; unchanged where D already is one)."""
    pad = -tensors[0].shape[-1] % 8
    if not pad:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in tensors)


def _select_blocks(name: str, kind: str, dtype: torch.dtype, sq: int,
                   sk: int, d: int, blocks: Optional[Tuple[int, int]] = None
                   ) -> Tuple[int, int]:
    """The compiled instance a launch takes, from the explicit (dtype, D,
    tile) table: bfloat16 -> a pair of ``autotune.INSTANCES`` (``blocks``
    or ``autotune.get_flash_blocks``; tensor cores up to D 256, the SIMT
    instance's pair past it), float32 -> the SIMT instance's one pair.
    Anything else raises."""
    if dtype == torch.float32:
        pair = autotune.SIMT_TILES[kind](d)
        if blocks is not None and tuple(blocks) != pair:
            raise ValueError(f"{name}: the float32 instance takes tiles "
                             f"{pair}, not {tuple(blocks)}")
        return pair
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {dtype}{_build.f16_note(dtype)}")
    pair = (tuple(blocks) if blocks is not None
            else autotune.get_flash_blocks(kind, sq, sk, d))
    if pair not in autotune.INSTANCES[(kind, autotune.head_dim_class(d))]:
        raise ValueError(f"{name}: no bfloat16 {kind} instance with tiles "
                         f"{pair} at head_dim {d}")
    return pair


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: Optional[float] = None,
                          q_offset: Offset = None,
                          blocks: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B, Sq, H, D], k/v [B, Sk, KVH, D] (paddle's layout; any strides
    with contiguous 16-byte-aligned head rows) -> (out [B, Sq, H, D] in q's
    dtype, lse [B, H, Sq] float32).  ``scale`` defaults to 1/sqrt(D);
    ``q_offset`` (causal only) is an int or a 0-d int32 device tensor,
    ``Sk - Sq`` when None.  ``blocks`` forces a (block_q, block_k) pair
    (``autotune.tune`` times them); by default the tile table picks.
    ``launches`` counts calls that launch (one CUDA kernel each).  The call
    is the op ``paddle_tpu_torch::flash_attention``."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    off_t = q_offset if isinstance(q_offset, torch.Tensor) else None
    off_i = None if q_offset is None or off_t is not None else int(q_offset)
    return _flash_fwd(q, k, v, bool(causal), scale, off_t, off_i,
                      None if blocks is None else [int(b) for b in blocks])


def _flash_fake(q, k, v, causal, scale, q_offset, q_offset_int, blocks):
    B, Sq, H, D = q.shape
    return (q.new_empty((B, Sq, H, D)),
            q.new_empty((B, H, Sq), dtype=torch.float32))


@_build.kernel_op("flash_attention(Tensor q, Tensor k, Tensor v, "
                  "bool causal, float scale, Tensor? q_offset, "
                  "int? q_offset_int, int[]? blocks) -> (Tensor, Tensor)",
                  fake=_flash_fake)
def _flash_fwd(q, k, v, causal, scale, q_offset, q_offset_int, blocks):
    """B1 (its plain version for CPU tensors): the real implementation
    checks, picks the tiles, reads the addresses, launches and counts;
    ``q_offset`` (a device tensor) and ``q_offset_int`` are the two kinds
    of ``flash_attention_fused``'s offset, at most one given."""
    off = q_offset if q_offset is not None else q_offset_int
    if q.device.type == "cpu":
        return _plain_bshd(q, k, v, causal, scale, off)
    return _flash_launch(q, k, v, causal, scale, off,
                         None if blocks is None else tuple(blocks))


def _flash_launch(q, k, v, causal, scale, q_offset, blocks):
    """B1 on CUDA tensors (a head dim that is not a multiple of 8
    zero-padded to the next one)."""
    name = "flash_attention_fused"
    D = q.shape[-1]
    if D % 8:
        out, lse = _flash_launch(*_pad8(q, k, v), causal, scale, q_offset,
                                 blocks)
        return out[..., :D].contiguous(), lse
    _check(name, q, k, v, q_offset)
    dt, stream = _build.launch_args(name, q, k, v)
    B, Sq, H, _ = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    bq, bk = _select_blocks(name, "fwd", q.dtype, Sq, Sk, D, blocks)
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
                int(bool(causal)), off, scale, bq, bk, dt, stream), name)
        flash_attention_fused.launches += 1
    return out, lse


def flash_attention_bwd_fused(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, g: torch.Tensor,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              blocks: Optional[Tuple[int, int]] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Kernel B8: the gradients of ``flash_attention_fused``'s output for
    the cotangent ``g`` [B, Sq, H, D], from its saved ``out`` and ``lse``
    [B, H, Sq] -> (dq [B, Sq, H, D], dk, dv [B, Sk, KVH, D]) in the inputs'
    dtype.  q/k/v as the forward takes them.  Causal is bottom-right
    (``Sk - Sq``).  ``blocks`` forces a tile pair, as the forward's; for
    GQA in bfloat16, ``_gqa_heads_per_block`` picks one query head per
    block or a block per group.  ``launches`` counts calls that launch: in
    bfloat16 a call is three or four CUDA kernels (pre-pass, main, dQ cast,
    GQA sum), in float32 two."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if q.device.type == "cpu":
        return _plain_bwd_bshd(q, k, v, out, lse, g, causal, scale)
    name = "flash_attention_bwd_fused"
    if D % 8:
        grads = flash_attention_bwd_fused(*_pad8(q, k, v, out), lse,
                                          *_pad8(g), causal, scale, blocks)
        return tuple(x[..., :D].contiguous() for x in grads)
    _check(name, q, k, v, None)
    out, g = out.contiguous(), g.contiguous()
    B, Sq, H, _ = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"{name}: out and g must be {tuple(q.shape)}")
    if (lse.shape != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be contiguous float32 "
                         f"[{B}, {H}, {Sq}]")
    dt, stream = _build.launch_args(name, q, k, v, out, g)
    bq, bk = _select_blocks(name, "bwd", q.dtype, Sq, Sk, D, blocks)
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, KVH, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, KVH, D), dtype=v.dtype, device=v.device)
    if B * H * Sq == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # rowsum(g * out): the pre-pass (bf16) or the dQ kernel (float32)
    # writes it for the kernels after it
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_acc = dkp = dvp = None
    hpb = 1
    if q.dtype == torch.bfloat16 and D <= 256:   # the tensor cores
        rep = H // KVH
        hpb = _gqa_heads_per_block(B, KVH, Sk, rep)
        dq_acc = torch.empty((B, Sq, H, D), **f32)
        if hpb < rep:
            dkp = torch.empty((B, Sk, H, D), **f32)
            dvp = torch.empty((B, Sk, H, D), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with _build.device_guard(q):
        _build.check(_build.lib().ptt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), ptr(dq_acc),
            ptr(dkp), ptr(dvp), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Sk, H, KVH, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(bool(causal)), scale, bq, bk, hpb, dt, stream), name)
    flash_attention_bwd_fused.launches += 1
    return dq, dk, dv


flash_attention_fused.launches = 0
flash_attention_bwd_fused.launches = 0


def _gqa_heads_per_block(B: int, KVH: int, Sk: int, rep: int) -> int:
    """B8's GQA mode: one query head per block (float32 dK/dV partials and
    a sum pass; B * H * Sk / 64 blocks) while a block per KV head would
    leave the card's 132 SMs short of two blocks each, else a block walks
    its group's heads (no partials).  chip_smoke.py phase 2 times both
    modes on either side of the threshold (PERF.md)."""
    if rep == 1:
        return 1
    return rep if B * KVH * -(-Sk // 64) >= 264 else 1


class _FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) with B1 forward and B8 backward; saves q, k,
    v, out and lse, as the reference's ``_flash_core_fwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fused(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_fused(q, k, v, out, lse, g,
                                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


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


def block_bwd(qb, kb, vb, o, lse, g, causal: bool, scale: float,
              kv_rep: int = 1):
    """Backward of one attention block (``block_fwd``'s layout): o and g
    [BH, Sq, D], lse [BH, Sq] -> (dq [BH, Sq, D], dk [BHk, Sk, D], dv [BHk, Sk, D])."""
    bh, sq, d = qb.shape
    bhk, sk, _ = kb.shape

    def q4(x):
        return x.reshape(bhk, kv_rep, sq, d).permute(0, 2, 1, 3)

    def kv4(x):
        return x.reshape(bhk, 1, sk, d).permute(0, 2, 1, 3)

    dq, dk, dv = flash_attention_bwd_fused(
        q4(qb), kv4(kb), kv4(vb), q4(o), lse.reshape(bhk, kv_rep, sq),
        q4(g), causal, scale)
    return (dq.permute(0, 2, 1, 3).reshape(bh, sq, d),
            dk.reshape(bhk, sk, d), dv.reshape(bhk, sk, d))


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        scale: Optional[float] = None,
                        q_offset: Offset = None) -> torch.Tensor:
    """Public entry: q [B, Sq, H, D], k/v [B, Sk, KVH, D] -> [B, Sq, H, D].
    K/V are never repeated to the query head count (the kernel indexes the
    group's KV head).  Differentiable in q, k and v (backward: B8) with the
    default causal offset; a gradient through a ``q_offset`` (the static
    ring's prefill, an inference path) is refused."""
    if _build.wants_grad(q, k, v):
        if q_offset is not None:
            raise NotImplementedError(
                "flash_attention_fwd: no backward for a q_offset (the "
                "static KV ring is an inference path)")
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_fused(q, k, v, causal, scale, q_offset)[0]
