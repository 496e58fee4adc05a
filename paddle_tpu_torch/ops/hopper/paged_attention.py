"""Paged-KV attention core — Hopper kernel K4 (``csrc/paged_attention.cu``).

The attention of ``paddle_tpu/ops/paged_attention.py:blha_attention``
(steps 6-8, ``:237-316``), which the JAX package leaves to XLA and computes
by gathering every sequence's whole context.  The kernel reads keys and
values through the block tables instead (online softmax, float32 state;
see the source's note).  It is bound on the H100 by the bytes of context
it reads.

``paged_plan`` divides the work, from sizes the host knows (never the row
lengths, which stay on the device): a block takes one row, a tile of up to
``qt`` of its tokens and one KV head with its query heads, walks the keys
``kt`` at a time, and the ``splits`` blocks of a cluster share the context
where the grid alone would give fewer blocks than the card has SMs.

Head dims: every D, read in place.  bfloat16 with D a multiple of 8 up
to 256 runs the tensor cores (columns past D zero-filled to 64, 128 or
256); the rest up to ``MAX_HEAD_DIM`` (512) runs the SIMT instance, which
holds D padded to 8 columns and copies rows in the largest pieces their
bytes allow, with 16-key tiles past 256 columns where larger rings do not
fit a block; past 512 the wide instance (both dtypes, one split;
``wide.py``) streams the head dim through shared memory in chunks, each
block writing one slice of at most 512 output columns.

``paged_attention`` runs the plain version (``_paged_attention_ref``, the
reference's gather + padded-batch attention transcribed) only for CPU
tensors.  For CUDA tensors it launches the kernel (one launch per call) or
raises; ``launches`` counts kernel launches.

``paged_attention_int8`` is K4-int8 (``csrc/paged_attention.cu``'s second
entry), the same attention over the int8 cache of ``cache_quant`` "static"
and "dynamic" (``blha_attention`` ``:237-254``): uint8 blocks read as
(u8 - 128) * d[b, kv], and each row's last ``now`` keys, this step's own,
read at full precision from the fresh k and v instead of the cache (the
reference's overlay).  Two instances, both with K4's split of the context
across a cluster where the grid is small: for bfloat16 where K4 runs its
tensor cores, K4's ``mma.sync`` walk over a ``cp.async`` ring of the uint8
codes, expanded in shared memory to bf16 u - 128 (exact), with d applied
to the scores and the probabilities; else a SIMT kernel over float32
tiles.  ``paged_int8_plan`` picks the instance, the query and key tiles
and the split from host sizes.  Its plain version is
``_paged_attention_int8_ref`` (CPU tensors only; no fallback on CUDA);
``paged_attention_int8.launches`` counts its launches.

Both wrappers take ``out_dtype``: None or q's dtype (the output rounded to
it once), or float32, which ``blha_attention`` asks for where its
epilogue reads the attention's float32 value.

Both take the pre-caches (``pre_key``, ``pre_value`` [B, KV, Lp, D] in q's
dtype, ``blha_attention``'s ``pre_key_cache`` / ``pre_value_cache``,
``:255-260``): the attention then runs over Lp prefix keys followed by the
row's paged context, every query sees the whole prefix, and paged key j
stays visible at positions >= j (the reference's ``kpos = arange(Lf) -
pre_len; vis = kpos <= qpos``).  In every instance the prefix is a second
source of key rows in the copier (key < Lp reads row ``pre[b, kh, key]``,
contiguous; K4-int8 reads it at full precision, as the step's fresh
keys), the plans count Lp in the context they split, and nothing is
written for it.

Both take the additive masks (``mask``, ``tgt_mask``: float32 [B, 1 | H,
Sq, Lm], ``blha_attention``'s, ``:285-308``) with ``seq_lens_encoder``
[B]: ``mask`` is added to the scores of the rows in prefill
(``seq_lens_encoder > 0``), ``tgt_mask`` to the others; query head h reads
mask head h (head 0 of a one-head mask), a token its local index's row,
key j of the combined axis (the prefix first) column j; rows past Sq and
columns past Lm add 0.  A masked call launches the masked instances
(``csrc/paged_attention_masked.cu``: every instance with ``kMask`` set,
to which the C entry hands a call with a mask); ``launches`` counts it as
any launch and ``mask_launches`` too.  The plans and shared memory are those of the
unmasked call: the kernels read the masks from global memory.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build, wide

__all__ = ["paged_attention", "paged_gather_kv", "paged_plan", "PagedPlan",
           "paged_attention_int8", "paged_int8_plan", "Int8Plan"]

# The card (an H100 SXM): streaming multiprocessors and the shared memory
# one block may opt into.
SMS = 132
SMEM_PER_BLOCK = 232448
THREADS = 128           # a block's threads (csrc kThreads)
VEC = 8                 # elements a thread takes of a row (csrc kVec)
KEY_TILES = (64, 32, 16)  # the SIMT key tiles, the larger preferred; 16
                          # only past 256 columns (csrc valid_plan)
MAX_HEAD_DIM = wide.MAX_HEAD_DIM  # past it, the wide instance
TC_KEYS = 64            # the tensor-core instance's key tile
TC_ROWS = 64            # the most query rows a tensor-core tile takes
STAGE_BYTES = 140 * 1024  # the K/V ring a SIMT block may take
# The plan's rules, from chip_smoke.py's sweep (--k4-sweep) on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md, section 6):
# * at most 4 splits: 4 beat 8 at every decode shape (8 / 2 heads at D 256:
#   0.0196 against 0.0292 ms; 2 rows of ~4000 keys: 0.0770 against
#   0.0832), and a grid of 256 blocks ran fastest unsplit (0.0374 against
#   0.0471 at 2);
# * tensor cores: 16 tokens (about 64 query rows) a tile, a ring of 2 (the
#   single step's mixed batch: 0.0492 ms against 0.0609 at 8 tokens and
#   0.0600 at 32; a ring of 3 gained nothing at decode, 0.0375 against
#   0.0374);
# * SIMT (float32): 8 query rows a tile and a ring of 3 (the mixed batch:
#   0.2261 ms against 0.2603 at 16 tokens and a ring of 2; decode 0.0865
#   against 0.1017).
SPLIT_CAP = 4                       # blocks of a cluster (csrc kMaxSplits)
TILE_ROWS = {True: 64, False: 8}    # query rows a tile aims at, by tc
MAX_QT = 16                         # tokens of a query tile
WIDE_ROWS = 16                      # query rows a wide tile aims at
STAGES = {True: (2,), False: (3, 2)}  # ring depths tried, by tc


class PagedPlan(NamedTuple):
    """How one K4 call divides its work: ``qt`` tokens of a row per query
    tile, ``kt`` keys per key tile in a ring of ``stages`` tiles,
    ``splits`` blocks (a cluster) per (query tile, KV head), each walking
    ``chunk`` keys; ``smem`` bytes of shared memory a block; ``blocks`` in
    the grid."""
    qt: int
    kt: int
    stages: int
    splits: int
    chunk: int
    smem: int
    blocks: int


def _row_chunks(D: int, es: int) -> int:
    c = D * es // 16
    return c + (c % 2 == 0)


def _tc(dtype: torch.dtype, D: int) -> bool:
    """Whether a call runs the tensor-core instance (csrc ``uses_tc``):
    bfloat16 with head_dim a multiple of 8 up to 256."""
    return dtype == torch.bfloat16 and D % 8 == 0 and D <= 256


def _simt_key_tiles(D: int):
    """The SIMT key tiles a head dim may take, the larger first."""
    return KEY_TILES if D > 256 else KEY_TILES[:-1]


def _tc_cols(D: int) -> int:
    """The tensor-core instance's columns: D padded to 64, 128 or 256."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _tc_key_groups(R: int) -> int:
    return 4 if R <= 16 else 2 if R <= 32 else 1


def _smem_bytes(tc: bool, R: int, D: int, es: int, kt: int, stages: int,
                splits: int, B: int, chunk: int, bs: int) -> int:
    """The kernel's shared-memory layout (csrc ``layout``): the K/V ring;
    the query rows (bf16 zero-padded to 16-row slabs and 64/128/256
    columns on the tensor cores; float32 on SIMT, with its scores and
    accumulators); row statistics; the leader's merge weights; the row
    tables and a split's block ids."""
    if tc:
        kg = _tc_key_groups(R)
        rp = 16 * (4 // kg)
        row = _row_chunks(_tc_cols(D), 2) * 16
        body = (2 * stages * kt * row + rp * row + 3 * rp * 4
                + 2 * kg * rp * 4)
    else:
        da = _ceil(D, VEC) * VEC
        slots = THREADS // (da // VEC)
        kg = 1
        while kg * 2 * R <= slots:
            kg *= 2
        rp = R
        row = _row_chunks(da, es) * 16
        body = (2 * stages * kt * row + R * da * 4 + R * kt * 4
                + kg * R * da * 4 + 4 * R * 4)
    return body + (splits + 1) * rp * 4 + (4 * B + 2 + chunk // bs + 2) * 4


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _grid_tiles(T: int, B: int, max_q_len: int, qt: int) -> int:
    """Query tiles in the grid (csrc ``grid_tiles``): at most
    ceil(max_q_len / qt) a row and at most what T tokens can fill."""
    by_rows = B * _ceil(max(max_q_len, 1), qt)
    return max(1, min(by_rows, (T + B * (qt - 1)) // qt))


def paged_plan(T: int, B: int, max_q_len: int, P: int, bs: int, H: int,
               KV: int, D: int, dtype: torch.dtype,
               pre_len: int = 0) -> PagedPlan:
    """The tile and split of a K4 call of T tokens in B rows, from
    host-known sizes only (``pre_len`` prefix keys before each row's
    ``P * bs`` paged ones: the context is their sum).

    * ``qt``: 1 at decode (``max_q_len`` 1); else up to ``MAX_QT`` tokens,
      so that a tile holds about ``TILE_ROWS`` query rows of G heads each
      (64 on the tensor cores, 8 on SIMT), and never more tokens than
      ``max_q_len``.  The grid holds the most query tiles that T tokens
      in B rows can fill; a block finds its row from the row lengths on
      the device.
    * The instance: tensor cores (``mma.sync``) for bfloat16 with D a
      multiple of 8 up to 256, at most ``TC_ROWS`` query rows a tile;
      SIMT otherwise (float32, the other bfloat16 head dims).
    * ``stages`` and ``kt``: a ring of 2 tiles of 64 keys on the tensor
      cores; on SIMT a ring of 3, else 2, of 64 keys, else 32 (else 16
      past 256 columns), the first whose ring takes at most
      ``STAGE_BYTES`` and whose block fits.
    * ``splits``: 1 where the grid of (query tile, KV head) blocks already
      gives every SM of the card a block; else the power of two that does,
      at most ``SPLIT_CAP`` and at most one key tile per split.  ``chunk``
      is the keys of ``pre_len + P * bs`` a split walks, a multiple of
      ``kt``.
    * Past ``MAX_HEAD_DIM`` columns: the wide instance, up to
      ``WIDE_ROWS`` query rows a tile (a larger group takes one token),
      32-key tiles, one split walking the whole context (``stages`` 1),
      a block for each slice of the output's columns
      (``wide.slice_cols``).

    Raises ValueError for a tensor-core tile of more than ``TC_ROWS``
    query rows (a head group above 64) and a shape whose block would need
    more than the 227 KB of shared memory a block may use."""
    return _plan(T, B, max_q_len, P, bs, H, KV, D, dtype, pre_len=pre_len)


@functools.lru_cache(maxsize=256)
def _plan(T: int, B: int, max_q_len: int, P: int, bs: int, H: int, KV: int,
          D: int, dtype: torch.dtype, qt: Optional[int] = None,
          splits: Optional[int] = None,
          stages: Optional[int] = None, pre_len: int = 0) -> PagedPlan:
    """``paged_plan``, with ``qt``, ``splits`` and ``stages`` replacing its
    choices when given (``chip_smoke.py`` holds the kernel to its plain
    version under such forced plans; the wrapper never forces one).  A
    forced ring depth the instance does not take, or more than
    ``SPLIT_CAP`` splits, raises ValueError."""
    if D <= 0 or KV <= 0 or H % KV or pre_len < 0:
        raise ValueError(f"paged_attention: no plan for H {H}, KV {KV}, "
                         f"head_dim {D}, {pre_len} prefix keys (head_dim "
                         ">= 1, H % KV == 0, pre_len >= 0)")
    es = dtype.itemsize
    G = H // KV
    ctx = P * bs + pre_len
    if D > MAX_HEAD_DIM:
        return _wide_plan(T, B, max_q_len, bs, G, KV, D, ctx, qt, splits,
                          stages)
    tc = _tc(dtype, D)
    if stages is not None and stages not in STAGES[tc]:
        raise ValueError(f"paged_attention: no ring of {stages} stages "
                         f"(the instance takes {STAGES[tc]})")
    if splits is not None and not 1 <= splits <= SPLIT_CAP:
        raise ValueError(f"paged_attention: {splits} splits, past the "
                         f"{SPLIT_CAP} blocks of a cluster")
    if qt is None:
        qt = 1 if max_q_len <= 1 else min(max_q_len, MAX_QT,
                                          max(1, TILE_ROWS[tc] // G))
    if tc and qt * G > TC_ROWS:
        raise ValueError(
            f"paged_attention: a tile of {qt * G} query rows ({H} heads "
            f"over {KV} KV heads) is past the {TC_ROWS} query rows of the "
            "tensor-core instance")
    row = _row_chunks(_tc_cols(D) if tc else _ceil(D, VEC) * VEC, es) * 16

    def smem(k, st, n, c):
        return _smem_bytes(tc, qt * G, D, es, k, st, n, B, c, bs)

    # the first ring depth, then key tile, whose block fits
    fits = [(st, k) for st in ((stages,) if stages else STAGES[tc])
            for k in ((TC_KEYS,) if tc else _simt_key_tiles(D))
            if (tc or 2 * st * k * row <= STAGE_BYTES)
            and smem(k, st, SPLIT_CAP, _ceil(ctx, k) * k) <= SMEM_PER_BLOCK]
    if not fits:
        kt = TC_KEYS if tc else _simt_key_tiles(D)[-1]
        need = smem(kt, 2, 1, _ceil(ctx, kt) * kt)
        raise ValueError(
            f"paged_attention: a block of {qt * G} query rows at head_dim "
            f"{D} ({H} heads over {KV} KV heads) needs {need} bytes of "
            f"shared memory, past the {SMEM_PER_BLOCK} (227 KB) a block may "
            "use")
    stages, kt = fits[0]
    base = _grid_tiles(T, B, max_q_len, qt) * KV
    cap = max(1, min(SPLIT_CAP, _ceil(ctx, kt)))
    if splits is None:
        splits = 1
        while splits < cap and base * splits < SMS:
            splits *= 2
    splits = min(splits, cap)
    chunk = max(kt, _ceil(_ceil(ctx, splits), kt) * kt)
    splits = max(1, _ceil(ctx, chunk))      # no split left without keys
    return PagedPlan(qt, kt, stages, splits, chunk,
                     smem(kt, stages, splits, chunk), base * splits)


def _wide_plan(T: int, B: int, max_q_len: int, bs: int, G: int, KV: int,
               D: int, ctx: int, qt: Optional[int], splits: Optional[int],
               stages: Optional[int]) -> PagedPlan:
    """``paged_plan`` past ``MAX_HEAD_DIM`` columns: the wide instance
    (csrc ``paged_attention_wide_kernel``)."""
    if splits not in (None, 1) or stages not in (None, 1):
        raise ValueError(f"paged_attention: the wide instance (head_dim "
                         f"past {MAX_HEAD_DIM}) takes one split and no "
                         f"ring, not {splits} splits, {stages} stages")
    if qt is None:
        qt = 1 if max_q_len <= 1 else min(max_q_len, MAX_QT,
                                          max(1, WIDE_ROWS // G))
    R = qt * G
    W = wide.slice_cols(R, D)
    if not W:
        raise ValueError(f"paged_attention: a block of {R} query rows at "
                         f"head_dim {D} does not fit the {SMEM_PER_BLOCK} "
                         "bytes (227 KB) a block may use")
    kt = wide.KEYS
    chunk = _ceil(ctx, kt) * kt
    smem = wide.smem_bytes(R, W) + (4 * B + 2 + chunk // bs + 2) * 4
    blocks = _grid_tiles(T, B, max_q_len, qt) * KV * _ceil(D, W)
    return PagedPlan(qt, kt, 1, 1, chunk, smem, blocks)


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


def _token_rows(cu_seqlens_q, seq_lens_this_time, T, B):
    """Each packed token's row, local index and validity (blha_attention
    step 2): token t belongs to row searchsorted(cu, t, right) - 1 and is
    valid while t < cu[-1] and its local index < its row's length."""
    cu = cu_seqlens_q.long()
    tok = torch.arange(T, device=cu.device)
    b_idx = (torch.searchsorted(cu, tok, right=True) - 1).clamp(0, B - 1)
    local = tok - cu[b_idx]
    valid = (tok < cu[-1]) & (local < seq_lens_this_time.long()[b_idx])
    return b_idx, local, valid


def _mask_bias(masks, H, S, L):
    """The masks' additive term of the padded batch's logits (``:285-308``),
    float32 [B, H, S, L], or None without masks: ``masks`` is (mask,
    tgt_mask, seq_lens_encoder, seq_lens_this_time); row b takes ``mask``
    where seq_lens_encoder[b] > 0, ``tgt_mask`` where it is <= 0 and
    seq_lens_this_time[b] > 0, else 0; each mask [B, 1 | H, Sq, Lm] is
    broadcast over the heads, zero-padded or cropped to S rows and L
    columns (the reference's ``_add_mask``)."""
    mask, tgt_mask, enc, now = masks
    if mask is None and tgt_mask is None:
        return None
    bias = None
    for m, rows in ((mask, enc > 0), (tgt_mask, (enc <= 0) & (now > 0))):
        if m is None:
            continue
        B, _, Sq, Lm = m.shape
        full = torch.zeros((B, H, S, L), dtype=torch.float32,
                           device=m.device)
        full[:, :, :min(Sq, S), :min(Lm, L)] = m.float()[
            :, :, :S, :L].expand(B, H, -1, -1)
        full = torch.where(rows[:, None, None, None], full, 0.0)
        bias = full if bias is None else bias + full
    return bias


def _attend_ref(q, k_all, v_all, seq_lens_decoder, rows, max_q_len,
                out_dtype=None, pre_len=0, masks=None):
    """blha_attention steps 7-8 over the gathered context k_all / v_all
    [B, KV, L, D], whose first ``pre_len`` keys are the pre-caches' (seen
    by every query; key j >= pre_len is visible at positions >= j -
    pre_len): padded-batch attention with float32 softmax, the masks'
    term (``_mask_bias`` of ``masks``) added after the causal mask,
    gathered back to the packed buffer and rounded once to ``out_dtype``
    (q's dtype when None); ``rows`` is ``_token_rows``'s."""
    T, H, D = q.shape
    B, KV, L = k_all.shape[:3]
    dev = q.device
    b_idx, local, valid = rows
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
    kpos = torch.arange(L, device=dev) - pre_len
    vis = kpos[None, None, :] <= qpos[:, :, None]
    logits = torch.where(vis[:, None, None], logits,
                         torch.tensor(-1e30, dtype=torch.float32, device=dev))
    bias = None if masks is None else _mask_bias(masks, H, S, L)
    if bias is not None:
        logits = logits + bias.view(B, KV, H // KV, S, L)
    p = torch.softmax(logits, dim=-1)
    out_pad = torch.einsum("bkgsl,bkld->bskgd", p, v_all.float())
    out_full = torch.zeros((B + 1, S + 1, H, D), dtype=torch.float32,
                           device=dev)
    out_full[:B, :S] = out_pad.reshape(B, S, H, D)
    return out_full[bs_idx, lc_idx].to(out_dtype or q.dtype)  # [T, H, D]


def _with_pre(ctx, pre):
    """The context [B, KV, L, D] with the pre-cache [B, KV, Lp, D] in
    front of it, in the context's dtype (``:255-260``), or as it is."""
    return ctx if pre is None else torch.cat([pre.to(ctx.dtype), ctx], 2)


def _paged_attention_ref(q, key_cache, value_cache, seq_lens_decoder,
                         seq_lens_this_time, cu_seqlens_q, block_tables,
                         max_q_len, out_dtype=None, pre_key=None,
                         pre_value=None, mask=None, tgt_mask=None,
                         seq_lens_encoder=None):
    """blha_attention steps 6-8: gather each row's context (after the
    pre-caches, where given), padded-batch attention with float32
    softmax and the masks' term, gather back to the packed buffer."""
    rows = _token_rows(cu_seqlens_q, seq_lens_this_time, q.shape[0],
                       block_tables.shape[0])
    return _attend_ref(
        q, _with_pre(paged_gather_kv(key_cache, block_tables), pre_key),
        _with_pre(paged_gather_kv(value_cache, block_tables), pre_value),
        seq_lens_decoder, rows, max_q_len, out_dtype,
        0 if pre_key is None else pre_key.shape[2],
        (mask, tgt_mask, seq_lens_encoder, seq_lens_this_time))


def _row_scales(scales, B):
    """Dequantization scales as [B, KV] float32: static [KV] scales are the
    same for every row."""
    return scales.float().expand(B, -1) if scales.dim() == 1 else scales


def _paged_attention_int8_ref(q, k, v, key_cache, value_cache,
                              k_dequant_scales, v_dequant_scales,
                              seq_lens_decoder, seq_lens_this_time,
                              cu_seqlens_q, block_tables, max_q_len,
                              out_dtype=None, pre_key=None, pre_value=None,
                              mask=None, tgt_mask=None,
                              seq_lens_encoder=None):
    """blha_attention steps 6-8 over the int8 cache (``:237-254``, then
    ``:262-316``): gather the uint8 blocks (a block id outside the pool
    gathers uint8 0), dequantize as (u8 - 128) * d[b, kv], overlay this
    step's full-precision k / v at each valid token's position, put the
    pre-caches (unquantized) in front, attend under the masks."""
    B = block_tables.shape[0]
    T, KV = q.shape[0], key_cache.shape[1]
    rows = _token_rows(cu_seqlens_q, seq_lens_this_time, T, B)
    b_idx, local, valid = rows
    ctx = []
    for cache, scales, new, pre in (
            (key_cache, k_dequant_scales, k, pre_key),
            (value_cache, v_dequant_scales, v, pre_value)):
        d = _row_scales(scales, B)[:, :, None, None]
        full = (paged_gather_kv(cache, block_tables).float() - 128.0) * d
        pos = seq_lens_decoder.long()[b_idx] + local
        ok = valid & (pos < full.shape[2])
        heads = torch.arange(KV, device=q.device)[None, :]
        full.index_put_((b_idx[ok][:, None], heads, pos[ok][:, None]),
                        new[ok].float())
        ctx.append(_with_pre(full, pre))
    return _attend_ref(q, ctx[0], ctx[1], seq_lens_decoder, rows, max_q_len,
                       out_dtype, 0 if pre_key is None else pre_key.shape[2],
                       (mask, tgt_mask, seq_lens_encoder, seq_lens_this_time))


def _out_dtype(name, q, out_dtype):
    """The output dtype a call asks for: None or q's dtype (q's), or
    float32; anything else raises ValueError."""
    if out_dtype is None or out_dtype == q.dtype:
        return q.dtype
    if out_dtype != torch.float32:
        raise ValueError(f"{name}: out_dtype must be None, q's dtype "
                         f"({q.dtype}) or torch.float32, got {out_dtype}")
    return out_dtype


def _check(name, q, key_cache, value_cache, ints, block_tables):
    T, H, D = q.shape
    NB, KV, _, Dc = key_cache.shape
    if value_cache.shape != key_cache.shape or Dc != D or H % KV:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit caches "
                         f"{tuple(key_cache.shape)}/{tuple(value_cache.shape)}")
    for t in (q, key_cache, value_cache, *ints, block_tables):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    for t in (q, key_cache, value_cache):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: q and the caches must be 16-byte "
                             "aligned (the kernel reads them in 16-byte "
                             "vectors)")
    for t in (*ints, block_tables):
        if t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{name}: lengths, cu_seqlens and block tables "
                             f"must be int32 on {q.device}")


def _pre_args(name, q, pre_key, pre_value, B, KV):
    """The pre-caches' pointers and length for a C entry: (0, 0, 0) for
    none; else both [B, KV, Lp, D] in q's dtype, contiguous and 16-byte
    aligned (the copies read their rows in the pieces of q's), on q's
    device."""
    if pre_key is None and pre_value is None:
        return 0, 0, 0
    D = q.shape[2]
    for t in (pre_key, pre_value):
        if (t is None or t.dim() != 4 or tuple(t.shape[:2]) != (B, KV)
                or t.shape[3] != D or t.shape != pre_key.shape
                or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: pre_key and pre_value must be contiguous, 16-byte "
                f"aligned [{B}, {KV}, Lp, {D}] {q.dtype} on {q.device}, got "
                + " / ".join("None" if x is None else
                             f"{tuple(x.shape)} {x.dtype}"
                             for x in (pre_key, pre_value)))
    return pre_key.data_ptr(), pre_value.data_ptr(), pre_key.shape[2]


def _check_masks(name, q, mask, tgt_mask, seq_lens_encoder, B):
    """The masks' shapes: each None or 4-D [B, 1 | H, Sq, Lm], and
    ``seq_lens_encoder`` [B] beside any (it picks the rows each mask
    reaches); a ValueError otherwise."""
    H = q.shape[1]
    for label, m in (("mask", mask), ("tgt_mask", tgt_mask)):
        if m is not None and (m.dim() != 4 or m.shape[0] != B
                              or m.shape[1] not in (1, H)):
            raise ValueError(f"{name}: {label} must be [{B}, 1 | {H}, Sq, "
                             f"Lm], got {tuple(m.shape)}")
    if (mask is not None or tgt_mask is not None) and (
            seq_lens_encoder is None
            or tuple(seq_lens_encoder.shape) != (B,)):
        raise ValueError(f"{name}: a mask needs seq_lens_encoder [{B}] "
                         "(it picks the rows each mask reaches)")


def _mask_args(name, q, mask, tgt_mask, seq_lens_encoder, B):
    """The masks' arguments for a C entry: (pointer, heads, rows, columns)
    of ``mask``, then of ``tgt_mask`` (zeros for one not given, or with no
    element), then ``seq_lens_encoder``'s pointer (0 without masks).  Each
    mask float32, contiguous and 16-byte aligned on q's device, shaped as
    ``_check_masks`` says; ``seq_lens_encoder`` int32 on q's device."""
    _check_masks(name, q, mask, tgt_mask, seq_lens_encoder, B)
    args = []
    for label, m in (("mask", mask), ("tgt_mask", tgt_mask)):
        if m is None or not m.numel():
            args += [0, 0, 0, 0]
            continue
        if (m.dtype != torch.float32 or m.device != q.device
                or not m.is_contiguous() or m.data_ptr() % 16):
            raise ValueError(f"{name}: {label} must be contiguous, 16-byte "
                             f"aligned float32 on {q.device}, got {m.dtype} "
                             f"on {m.device}")
        args += [m.data_ptr(), m.shape[1], m.shape[2], m.shape[3]]
    if not (args[0] or args[4]):
        return (0,) * 9
    if (seq_lens_encoder.dtype != torch.int32
            or seq_lens_encoder.device != q.device
            or not seq_lens_encoder.is_contiguous()):
        raise ValueError(f"{name}: seq_lens_encoder must be contiguous int32 "
                         f"on {q.device}")
    return (*args, seq_lens_encoder.data_ptr())


def paged_attention(q: torch.Tensor, key_cache: torch.Tensor,
                    value_cache: torch.Tensor,
                    seq_lens_decoder: torch.Tensor,
                    seq_lens_this_time: torch.Tensor,
                    cu_seqlens_q: torch.Tensor, block_tables: torch.Tensor,
                    max_q_len: int,
                    out_dtype: Optional[torch.dtype] = None,
                    pre_key: Optional[torch.Tensor] = None,
                    pre_value: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    tgt_mask: Optional[torch.Tensor] = None,
                    seq_lens_encoder: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q [T, H, D] (after rope), caches [NB, KV, bs, D] already holding this
    step's keys and values, seq_lens_decoder/this_time [B], cu_seqlens_q
    [B+1], block_tables [B, P] -> attention output [T, H, D] in q's dtype,
    or float32 with ``out_dtype=torch.float32`` (the float32 value,
    unrounded).  Token i of row b sits at ``dec_b + (i - cu_b)`` and attends
    its row's keys up to that position, after the whole of the pre-caches
    ``pre_key`` / ``pre_value`` [B, KV, Lp, D] (q's dtype) where given;
    tokens past ``cu[-1]``, past their row's length, or at a local index
    >= ``max_q_len`` give zeros.  ``mask`` / ``tgt_mask`` [B, 1 | H, Sq,
    Lm] (float32) add to the scores of the rows in prefill / the others,
    as ``seq_lens_encoder`` [B] says (module docstring)."""
    od = _out_dtype("paged_attention", q, out_dtype)
    masks = dict(mask=mask, tgt_mask=tgt_mask,
                 seq_lens_encoder=seq_lens_encoder)
    if q.device.type == "cpu":
        _check_masks("paged_attention", q, mask, tgt_mask, seq_lens_encoder,
                     block_tables.shape[0])
        return _paged_attention_ref(q, key_cache, value_cache,
                                    seq_lens_decoder, seq_lens_this_time,
                                    cu_seqlens_q, block_tables, max_q_len,
                                    od, pre_key, pre_value, **masks)
    return _launch(q, key_cache, value_cache, seq_lens_decoder,
                   seq_lens_this_time, cu_seqlens_q, block_tables, max_q_len,
                   od, pre_key=pre_key, pre_value=pre_value, **masks)


def _launch(q, key_cache, value_cache, seq_lens_decoder, seq_lens_this_time,
            cu_seqlens_q, block_tables, max_q_len, out_dtype=None,
            pre_key=None, pre_value=None, mask=None, tgt_mask=None,
            seq_lens_encoder=None, **force):
    """The kernel's launch for CUDA tensors, under ``paged_plan``'s plan or
    one that ``force`` (``qt``, ``splits``, ``stages``) fixes in part."""
    name = "paged_attention"
    od = _out_dtype(name, q, out_dtype)
    ints = (seq_lens_decoder, seq_lens_this_time, cu_seqlens_q)
    _check(name, q, key_cache, value_cache, ints, block_tables)
    dt, stream = _build.launch_args(name, q, key_cache, value_cache)
    T, H, D = q.shape
    NB, KV, bs, _ = key_cache.shape
    B, P = block_tables.shape
    pk, pv, Lp = _pre_args(name, q, pre_key, pre_value, B, KV)
    mk = _mask_args(name, q, mask, tgt_mask, seq_lens_encoder, B)
    if not B:                   # no rows: every token gives zeros
        return torch.zeros_like(q, dtype=od)
    plan = _plan(T, B, int(max_q_len), P, bs, H, KV, D, q.dtype, **force,
                 pre_len=Lp)
    out = torch.empty_like(q, dtype=od)
    if T:
        with _build.device_guard(q):
            _build.check(_build.lib().ptt_paged_attention(
                q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
                out.data_ptr(), seq_lens_decoder.data_ptr(),
                seq_lens_this_time.data_ptr(), cu_seqlens_q.data_ptr(),
                block_tables.data_ptr(), pk, pv, T, B, P, NB, H, KV, D, bs,
                Lp, int(max_q_len), 1.0 / math.sqrt(D), plan.qt, plan.kt,
                plan.stages, plan.splits, plan.chunk,
                int(od == torch.float32), *mk, dt, stream), name)
        paged_attention.launches += 1
        paged_attention.mask_launches += bool(mk[8])
    return out


# K4-int8's SIMT instance (csrc ``paged_attention_int8_kernel``): key tiles
# whose two float32 K/V tiles stay within INT8_TILE_BYTES, the larger first
INT8_KEY_TILES = (64, 32, 16, 8)
INT8_TILE_BYTES = 72 * 1024


class Int8Plan(NamedTuple):
    """One K4-int8 launch: ``qt`` tokens of a row per query tile, ``kt``
    keys a tile, ``splits`` blocks (a cluster) per (query tile, KV head),
    each walking ``chunk`` keys; ``smem`` bytes of shared memory a block,
    ``blocks`` in the grid; ``tc``: the tensor-core instance (csrc
    ``paged_attention_int8_mma_kernel``), else the SIMT one."""
    qt: int
    kt: int
    splits: int
    chunk: int
    smem: int
    blocks: int
    tc: bool = False


def _int8_smem_bytes(R: int, D: int, kt: int, splits: int, B: int,
                     chunk: int, bs: int, tc: bool = False) -> int:
    """K4-int8's shared-memory layout.  SIMT (csrc ``int8_layout``): the
    float32 K and V tiles, the query rows, scores, the key groups'
    accumulators, row statistics and the row tables with the row's block
    ids.  Tensor cores: K4's own (``_smem_bytes``), its ring of two
    stages of bf16-sized rows holding the codes until they are expanded."""
    if tc:
        return _smem_bytes(True, R, D, 2, kt, STAGES[True][0], splits, B,
                           chunk, bs)
    da = _ceil(D, VEC) * VEC
    dc = da // VEC
    slots = 1 if dc >= THREADS else THREADS // dc
    kg = 1
    while kg * 2 * R <= slots:
        kg *= 2
    rs = _row_chunks(da, 4) * 4
    return 4 * (2 * kt * rs + R * da + R * kt + kg * R * da + 4 * R
                + (splits + 1) * R + 4 * B + 2 + chunk // bs + 2)


def paged_int8_plan(T: int, B: int, max_q_len: int, P: int, bs: int,
                    H: int, KV: int, D: int,
                    dtype: torch.dtype = torch.float32,
                    pre_len: int = 0) -> Int8Plan:
    """K4-int8's instance and tiles, from host-known sizes only (the
    context split is ``pre_len + P * bs`` keys, as ``paged_plan``'s).

    * Tensor cores (``tc``) for bfloat16 where K4 runs its own (D a
      multiple of 8 up to 256) and a tile of one token holds at most
      ``TC_ROWS`` query rows: K4's plan (``paged_plan``) as it is.
    * SIMT otherwise: ``qt`` as K4's SIMT instance (1 at decode, else up to
      ``MAX_QT`` tokens of about 8 query rows); ``kt`` the largest of
      ``INT8_KEY_TILES`` whose K/V tiles take at most ``INT8_TILE_BYTES``
      (64 keys at D 128, 32 at 256, 16 at 512, 8 past); then ``qt`` halves,
      and past that ``kt``, until the block fits the 227 KB a block may
      use; ``splits`` as K4's (1 where the grid gives every SM a block,
      else the power of two that does, at most ``SPLIT_CAP``).

    Raises ValueError where one token's query rows do not fit at 8 keys."""
    return _int8_plan(T, B, max_q_len, P, bs, H, KV, D, dtype,
                      pre_len=pre_len)


@functools.lru_cache(maxsize=256)
def _int8_plan(T: int, B: int, max_q_len: int, P: int, bs: int, H: int,
               KV: int, D: int, dtype: torch.dtype,
               tc: Optional[bool] = None,
               splits: Optional[int] = None, pre_len: int = 0) -> Int8Plan:
    """``paged_int8_plan``, with ``tc`` (the instance) and ``splits``
    replacing its choices when given (``chip_smoke.py`` times the SIMT
    instance on bfloat16 beside the tensor cores and holds both to the
    plain version under forced splits; the wrapper forces SIMT only for
    inputs whose alignment the tensor-core copies cannot take).  A forced
    ``tc`` the shape does not allow, or more than ``SPLIT_CAP`` splits,
    raises ValueError."""
    if D <= 0 or KV <= 0 or H % KV or pre_len < 0:
        raise ValueError(f"paged_attention_int8: no plan for H {H}, KV {KV}, "
                         f"head_dim {D}, {pre_len} prefix keys (head_dim "
                         ">= 1, H % KV == 0, pre_len >= 0)")
    G = H // KV
    ctx = P * bs + pre_len
    can_tc = _tc(dtype, D) and G <= TC_ROWS
    if tc and not can_tc:
        raise ValueError(f"paged_attention_int8: no tensor-core instance for "
                         f"{dtype} at head_dim {D} with {G} query heads a KV "
                         "head")
    if splits is not None and not 1 <= splits <= SPLIT_CAP:
        raise ValueError(f"paged_attention_int8: {splits} splits, past the "
                         f"{SPLIT_CAP} blocks of a cluster")
    if can_tc if tc is None else tc:
        p = _plan(T, B, max_q_len, P, bs, H, KV, D, torch.bfloat16,
                  splits=splits, pre_len=pre_len)
        return Int8Plan(p.qt, p.kt, p.splits, p.chunk, p.smem, p.blocks,
                        True)
    rs = _row_chunks(_ceil(D, VEC) * VEC, 4) * 4
    tiles = [k for k in INT8_KEY_TILES if 2 * k * rs * 4 <= INT8_TILE_BYTES]
    qt0 = 1 if max_q_len <= 1 else min(max_q_len, MAX_QT,
                                       max(1, TILE_ROWS[False] // G))

    def smem(qt, kt, splits, chunk):
        return _int8_smem_bytes(qt * G, D, kt, splits, B, chunk, bs)

    for kt in tiles or INT8_KEY_TILES[-1:]:
        # fitted at the most splits and the whole context's block ids
        qt, whole = qt0, _ceil(ctx, kt) * kt
        while qt > 1 and smem(qt, kt, SPLIT_CAP, whole) > SMEM_PER_BLOCK:
            qt //= 2
        if smem(qt, kt, SPLIT_CAP, whole) > SMEM_PER_BLOCK:
            continue
        base = _grid_tiles(T, B, max_q_len, qt) * KV
        cap = max(1, min(SPLIT_CAP, _ceil(ctx, kt)))
        n = splits
        if n is None:
            n = 1
            while n < cap and base * n < SMS:
                n *= 2
        n = min(n, cap)
        chunk = max(kt, _ceil(_ceil(ctx, n), kt) * kt)
        n = max(1, _ceil(ctx, chunk))       # no split left without keys
        return Int8Plan(qt, kt, n, chunk, smem(qt, kt, n, chunk), base * n)
    raise ValueError(
        f"paged_attention_int8: a block of {G} query rows at head_dim {D} "
        f"needs {smem(1, 8, SPLIT_CAP, _ceil(ctx, 8) * 8)} bytes of shared "
        f"memory, past the {SMEM_PER_BLOCK} (227 KB) a block may use")


def paged_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         key_cache: torch.Tensor, value_cache: torch.Tensor,
                         k_dequant_scales: torch.Tensor,
                         v_dequant_scales: torch.Tensor,
                         seq_lens_decoder: torch.Tensor,
                         seq_lens_this_time: torch.Tensor,
                         cu_seqlens_q: torch.Tensor,
                         block_tables: torch.Tensor, max_q_len: int,
                         out_dtype: Optional[torch.dtype] = None,
                         pre_key: Optional[torch.Tensor] = None,
                         pre_value: Optional[torch.Tensor] = None,
                         mask: Optional[torch.Tensor] = None,
                         tgt_mask: Optional[torch.Tensor] = None,
                         seq_lens_encoder: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """K4-int8: q [T, H, D] (after rope), this step's full-precision k and v
    [T, KV, D] (q's dtype; each head's row contiguous, any token stride),
    uint8 caches [NB, KV, bs, D] already holding this step's quantized
    keys and values, float32 dequantization scales [B, KV] (dynamic) or
    [KV] (static), lengths as ``paged_attention`` -> [T, H, D] in q's
    dtype, or float32 with ``out_dtype=torch.float32``.  Row b's keys
    before ``seq_lens_decoder[b]`` read (u8 - 128) * d[b, kv] (uint8 0 for
    a block id outside the pool); its keys from there on are this step's,
    read from k and v at token ``cu[b] + (key - dec[b])``, not from the
    cache.  The pre-caches ``pre_key`` / ``pre_value`` [B, KV, Lp, D] (q's
    dtype, full precision), where given, come before every row's context
    and are seen by every query; the masks as ``paged_attention``'s."""
    od = _out_dtype("paged_attention_int8", q, out_dtype)
    masks = dict(mask=mask, tgt_mask=tgt_mask,
                 seq_lens_encoder=seq_lens_encoder)
    if q.device.type == "cpu":
        _check_masks("paged_attention_int8", q, mask, tgt_mask,
                     seq_lens_encoder, block_tables.shape[0])
        return _paged_attention_int8_ref(
            q, k, v, key_cache, value_cache, k_dequant_scales,
            v_dequant_scales, seq_lens_decoder, seq_lens_this_time,
            cu_seqlens_q, block_tables, max_q_len, od, pre_key, pre_value,
            **masks)
    return _launch_int8(q, k, v, key_cache, value_cache, k_dequant_scales,
                        v_dequant_scales, seq_lens_decoder,
                        seq_lens_this_time, cu_seqlens_q, block_tables,
                        max_q_len, od, pre_key=pre_key, pre_value=pre_value,
                        **masks)


def _tc_aligned(k, v, key_cache, value_cache) -> bool:
    """Whether the tensor-core instance's copies take these inputs: k and v
    16-byte aligned with token strides of whole 16 bytes, the pools
    aligned to their rows' pieces (16 bytes where D % 16 == 0, else 8)."""
    piece = 16 if key_cache.shape[3] % 16 == 0 else 8
    return (all(t.data_ptr() % 16 == 0 and t.stride(0) * t.element_size()
                % 16 == 0 for t in (k, v))
            and all(t.data_ptr() % piece == 0
                    for t in (key_cache, value_cache)))


def _int8_launch_plan(q, k, v, key_cache, value_cache, block_tables,
                      max_q_len, tc=None, splits=None, pre_len=0) -> Int8Plan:
    """The plan ``_launch_int8`` launches for these inputs:
    ``paged_int8_plan``'s, or its instance and split count forced by ``tc``
    and ``splits``; SIMT where the plan takes the tensor cores unforced but
    their copies do not take k, v or the pools (``_tc_aligned``)."""
    T, H, D = q.shape
    _, KV, bs, _ = key_cache.shape
    B, P = block_tables.shape
    plan = _int8_plan(T, B, int(max_q_len), P, bs, H, KV, D, q.dtype, tc,
                      splits, pre_len)
    if plan.tc and tc is None and not _tc_aligned(k, v, key_cache,
                                                  value_cache):
        plan = _int8_plan(T, B, int(max_q_len), P, bs, H, KV, D, q.dtype,
                          False, splits, pre_len)
    return plan


def _launch_int8(q, k, v, key_cache, value_cache, k_dequant_scales,
                 v_dequant_scales, seq_lens_decoder, seq_lens_this_time,
                 cu_seqlens_q, block_tables, max_q_len, out_dtype=None,
                 tc=None, splits=None, pre_key=None, pre_value=None,
                 mask=None, tgt_mask=None, seq_lens_encoder=None):
    """K4-int8's launch for CUDA tensors, under ``paged_int8_plan`` (or its
    instance and split count forced by ``tc`` and ``splits``)."""
    name = "paged_attention_int8"
    od = _out_dtype(name, q, out_dtype)
    T, H, D = q.shape
    NB, KV, bs, Dc = key_cache.shape
    B, P = block_tables.shape
    for t in (k, v):
        if (tuple(t.shape) != (T, KV, D) or t.stride(2) != 1
                or (KV > 1 and t.stride(1) != D)):
            raise ValueError(f"{name}: k and v must be [{T}, {KV}, {D}] with "
                             f"each head's row contiguous, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    for t in (key_cache, value_cache):
        if (t.dtype != torch.uint8 or tuple(t.shape) != (NB, KV, bs, D)
                or not t.is_contiguous() or t.device != q.device
                or H % KV or Dc != D):
            raise ValueError(f"{name}: caches must be contiguous uint8 "
                             f"[NB, KV, bs, {D}] on {q.device} for q "
                             f"{tuple(q.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    scales = []
    for t in (k_dequant_scales, v_dequant_scales):
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) not in ((KV,), (B, KV))):
            raise ValueError(f"{name}: dequantization scales must be float32 "
                             f"[{KV}] or [{B}, {KV}] on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        scales.append(_row_scales(t, B).contiguous())
    ints = (seq_lens_decoder, seq_lens_this_time, cu_seqlens_q)
    for t in (*ints, block_tables):
        if (t.dtype != torch.int32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: lengths, cu_seqlens and block tables "
                             f"must be contiguous int32 on {q.device}")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    dt, stream = _build.launch_args(name, q, k, v)
    pk, pv, Lp = _pre_args(name, q, pre_key, pre_value, B, KV)
    mk = _mask_args(name, q, mask, tgt_mask, seq_lens_encoder, B)
    if not B:                   # no rows: every token gives zeros
        return torch.zeros_like(q, dtype=od)
    plan = _int8_launch_plan(q, k, v, key_cache, value_cache, block_tables,
                             max_q_len, tc, splits, Lp)
    out = torch.empty_like(q, dtype=od)
    if T:
        with _build.device_guard(q):
            _build.check(_build.lib().ptt_paged_attention_int8(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                key_cache.data_ptr(), value_cache.data_ptr(),
                scales[0].data_ptr(), scales[1].data_ptr(), out.data_ptr(),
                seq_lens_decoder.data_ptr(), seq_lens_this_time.data_ptr(),
                cu_seqlens_q.data_ptr(), block_tables.data_ptr(), pk, pv, T,
                B, P, NB, H, KV, D, bs, Lp, int(max_q_len), k.stride(0),
                v.stride(0),
                1.0 / math.sqrt(D), plan.qt, plan.kt, plan.splits,
                plan.chunk, int(plan.tc), int(od == torch.float32), *mk, dt,
                stream), name)
        paged_attention_int8.launches += 1
        paged_attention_int8.mask_launches += bool(mk[8])
    return out


paged_attention.launches = 0
paged_attention.mask_launches = 0
paged_attention_int8.launches = 0
paged_attention_int8.mask_launches = 0
