"""Decode attention over the static KV ring and the in-place ring write —
Hopper kernels B2 and B3 (``csrc/decode_attention.cu``).

Port of ``paddle_tpu/ops/pallas/decode_attention.py``:
``decode_attention`` replaces ``decode_attention`` (``_decode_kernel``):
one query token per row against the ring ``[B, L, KVH, D]`` in its native
layout, columns ``<= pos``; ``kv_ring_write`` replaces ``kv_ring_write``:
the step's rows written into the ring in place.  Both read ``pos`` from
device memory, so a decode loop needs no host sync.  Both are bound on the
H100 by bytes (see the source's note).

``decode_plan`` divides B2's work from sizes the host knows (never pos): a
block takes one row, one KV head and up to 16 of its query heads, walks its
share of the keys ``kt`` at a time through a ring of two tiles, and the
``splits`` blocks of a thread-block cluster share keys ``0 .. pos`` (each
reads pos on the device) where the grid alone would leave the card's SMs
without a block.  One launch per call; nothing is allocated but the
output.

Beside the reference, ``kv_ring_write`` writes the K and the V ring in one
launch and takes ``S >= 1`` rows at ``pos .. pos + S - 1`` (the static
prefill), with the start taken as ``dynamic_update_slice`` takes it: a
negative pos counts from the end first, then the start is clamped to
``[0, L - S]``.  The generation path folds this write into rope's launch
(``fused_ops.rope_ring_fused``); B3 serves ``kv_ring_write``'s own callers.

Head dims: every D, in place (a per-call pad would copy the ring).
bfloat16 with D a multiple of 8 up to 256 runs the tensor cores; the rest
up to ``MAX_HEAD_DIM`` (512) runs the SIMT instance, which reads rows in
the largest pieces their bytes allow; past it the wide instance (both
dtypes, one split; ``wide.py``) streams the head dim through shared
memory in chunks, each block writing one slice of at most 512 output
columns.  A negative pos sees no key: B2 gives zeros, as the Pallas kernel
does.

A wrapper runs the plain version (``ref_decode_attention``, the
reference's jnp reference transcribed; ``_ref_ring_write``, an
``index_copy_``) only for CPU tensors.  For CUDA tensors it launches the
kernel or raises; ``launches`` counts wrapper calls that launched.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build, wide

__all__ = ["ref_decode_attention", "decode_attention", "kv_ring_write",
           "decode_plan", "DecodePlan"]

NEG_INF = -1e30
# The card (an H100 SXM): streaming multiprocessors and the shared memory
# one block may opt into.
SMS = 132
SMEM_PER_BLOCK = 232448
THREADS = 128           # a block's threads (csrc kThreads)
ROWS = 16               # query heads a block takes (csrc kRows)
VEC = 8                 # elements a SIMT thread takes of a row (csrc kVec)
SPLIT_CAP = 8           # blocks of a cluster (csrc kMaxSplits)
MAX_HEAD_DIM = wide.MAX_HEAD_DIM  # past it, the wide instance
# Keys of a tile by tc (tensor cores) (csrc kTcKeys, kSimtKeys), in a ring
# of 2 tiles (csrc kStages).  The plan's rules, from chip_smoke.py's sweep
# (--b2-sweep) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6):
# larger tiles and deeper rings gained nothing at generation's contexts;
# splits only where the grid leaves SMs without a block, and only while
# each split keeps MIN_SPLIT_TILES key tiles of the ring (a cluster's merge
# costs more than a split of a short ring saves).
KEY_TILE = {True: 64, False: 32}
WIDE_KEY_TILE = 16      # float32 SIMT past 256 columns (csrc simt_keys)
STAGES = 2
MIN_SPLIT_TILES = 4


class DecodePlan(NamedTuple):
    """How one B2 call divides its work: the tensor-core instance (``tc``,
    bfloat16) or SIMT (float32); ``rows`` query heads a block; ``kt`` keys
    a tile; ``splits`` blocks (a cluster) a (row, head chunk); ``smem``
    bytes of shared memory a block; ``blocks`` in the grid."""
    tc: bool
    rows: int
    kt: int
    splits: int
    smem: int
    blocks: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _row_chunks(D: int, es: int) -> int:
    c = D * es // 16
    return c + (c % 2 == 0)


def _tc_cols(D: int) -> int:
    """The tensor-core instance's columns: D padded to 64, 128 or 256."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _tc(dtype: torch.dtype, D: int) -> bool:
    """Whether a call runs the tensor-core instance (csrc ``uses_tc``):
    bfloat16 with D a multiple of 8 up to 256."""
    return dtype == torch.bfloat16 and D % 8 == 0 and D <= 256


def _key_tile(tc: bool, es: int, D: int) -> int:
    """Keys of a tile (csrc ``kTcKeys``, ``simt_keys``)."""
    return KEY_TILE[tc] if tc or es == 2 or D <= 256 else WIDE_KEY_TILE


def _smem_bytes(tc: bool, R: int, D: int, es: int, splits: int) -> int:
    """The kernel's shared-memory layout (csrc ``layout``): the K/V ring;
    the query rows (bf16 zero-padded to 16 rows and 64/128/256 columns on
    the tensor cores, with the warps' row statistics; float32 on SIMT, D
    padded to 8 columns, with its scores and accumulators); the leader's
    merge (each split's weight and l by row, 1 / L)."""
    kt = _key_tile(tc, es, D)
    if tc:
        row = _row_chunks(_tc_cols(D), 2) * 16
        body = (2 * STAGES * kt * row + ROWS * row + 2 * ROWS * 4
                + 2 * (THREADS // 32) * ROWS * 4)
        rp = ROWS
    else:
        da = _ceil(D, VEC) * VEC
        slots = THREADS // (da // VEC)
        kg = 1
        while kg * 2 * R <= slots:
            kg *= 2
        row = _row_chunks(da, es) * 16
        body = (2 * STAGES * kt * row + R * da * 4 + R * kt * 4
                + kg * R * da * 4 + 3 * R * 4)
        rp = R
    return body + (2 * splits + 1) * rp * 4


def decode_plan(B: int, L: int, H: int, KVH: int, D: int,
                dtype: torch.dtype) -> DecodePlan:
    """The tiles and split of a B2 call over a ring of L rows, from
    host-known sizes only (never pos).

    * ``rows``: a block takes one row, one KV head and up to 16 of its
      G = H / KVH query heads; a larger group takes ceil(G / 16) blocks.
    * ``tc``: bfloat16 with D a multiple of 8 up to 256 runs on the
      tensor cores (``mma.sync``, the heads padded to 16 rows, 64-key
      tiles), the rest on the SIMT instance (32-key tiles; 16 in float32
      past 256 columns).
    * ``splits``: 1 where the grid of (row, KV head, head chunk) blocks
      already gives every SM of the card a block; else the power of two
      that does, at most ``SPLIT_CAP`` and at most one for each
      ``MIN_SPLIT_TILES`` key tiles of the ring.  On the device each split
      takes an even, tile-aligned share of keys 0 .. pos.
    * Past ``MAX_HEAD_DIM`` columns: the wide instance, 32-key tiles, one
      split, a block for each slice of the output's columns
      (``wide.slice_cols``).

    Raises ValueError for a shape the kernel does not take (H not a
    multiple of KVH, a dtype other than bfloat16 and float32)."""
    return _plan(B, L, H, KVH, D, dtype)


@functools.lru_cache(maxsize=256)
def _plan(B: int, L: int, H: int, KVH: int, D: int, dtype: torch.dtype,
          splits: Optional[int] = None) -> DecodePlan:
    """``decode_plan``, with ``splits`` replacing its choice when given
    (``chip_smoke.py`` holds the kernel to its plain version under every
    split count; the wrapper never forces one).  A forced count the kernel
    does not take raises ValueError."""
    name = "decode_attention"
    if D <= 0 or KVH <= 0 or H % KVH:
        raise ValueError(f"{name}: no plan for H {H}, KVH {KVH}, head_dim "
                         f"{D} (head_dim >= 1, H % KVH == 0)")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: no instance for {dtype}"
                         f"{_build.f16_note(dtype)}")
    G = H // KVH
    R = min(G, ROWS)
    base = B * KVH * _ceil(G, ROWS)
    if D > MAX_HEAD_DIM:
        if splits not in (None, 1):
            raise ValueError(f"{name}: the wide instance (head_dim past "
                             f"{MAX_HEAD_DIM}) takes one split, not "
                             f"{splits}")
        W = wide.slice_cols(R, D)
        return DecodePlan(False, R, wide.KEYS, 1, wide.smem_bytes(R, W),
                          base * _ceil(D, W))
    tc = _tc(dtype, D)
    kt = _key_tile(tc, dtype.itemsize, D)
    cap = max(1, min(SPLIT_CAP, _ceil(L, kt)))
    if splits is None:
        splits = 1
        while (splits < cap and base * splits < SMS
               and L >= 2 * splits * MIN_SPLIT_TILES * kt):
            splits *= 2
    elif splits not in (1, 2, 4, SPLIT_CAP) or splits > cap:
        raise ValueError(f"{name}: {splits} splits (a cluster takes 1, 2, 4 "
                         f"or {SPLIT_CAP} blocks, at most the {cap} key "
                         f"tiles of a ring of {L} rows)")
    smem = _smem_bytes(tc, R, D, dtype.itemsize, splits)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{name}: a block at head_dim {D} needs {smem} bytes "
                         f"of shared memory, past the {SMEM_PER_BLOCK} "
                         "(227 KB) a block may use")
    return DecodePlan(tc, R, kt, splits, smem, base * splits)


def ref_decode_attention(q, kbuf, vbuf, pos, scale: Optional[float] = None):
    """q [B, 1, H, D], kbuf/vbuf [B, L, KVH, D], pos (int or 0-d tensor):
    attend to cols <= pos with a float32 softmax -> [B, 1, H, D]; a
    negative pos sees no key and gives zeros, as the Pallas kernel (its
    jnp reference averages every row there instead)."""
    b, _, h, d = q.shape
    l, kvh = kbuf.shape[1], kbuf.shape[2]
    scale = scale or 1.0 / math.sqrt(d)
    rep = h // kvh
    qh = q.transpose(1, 2).float()                          # [B, H, 1, D]
    kh = kbuf.transpose(1, 2).float()                       # [B, KVH, L, D]
    vh = vbuf.transpose(1, 2).float()
    if rep > 1:
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * scale
    cols = torch.arange(l, device=q.device)
    s = torch.where(cols[None, None, None, :] <= pos, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    o = torch.where(torch.as_tensor(pos, device=q.device) >= 0, o, 0.0)
    return o.transpose(1, 2).to(q.dtype)


def _ring_start(pos, L: int, S: int):
    """dynamic_update_slice's start of S rows in a ring of L: a negative
    pos counts from the end first, then the start is clamped to [0, L - S]
    (a 0-d int64 tensor on pos's device, or on the CPU for an int)."""
    p = torch.as_tensor(pos).long()
    return torch.clamp(torch.where(p < 0, p + L, p), 0, L - S)


def _ref_ring_write(kbuf, vbuf, k, v, pos):
    S, L = k.shape[1], kbuf.shape[1]
    start = _ring_start(pos, L, S).to(kbuf.device)
    rows = start + torch.arange(S, device=kbuf.device)
    kbuf.index_copy_(1, rows, k.to(kbuf.dtype))
    vbuf.index_copy_(1, rows, v.to(vbuf.dtype))
    return kbuf, vbuf


def _check_pos(name, pos, device):
    if not (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32
            and pos.numel() == 1 and pos.device == device):
        raise ValueError(f"{name}: pos must be one int32 on {device}")


def _check_ring(name, t, B, L, KVH, D, align=16):
    if (tuple(t.shape) != (B, L, KVH, D) or not t.is_contiguous()
            or t.data_ptr() % align):
        raise ValueError(f"{name}: ring buffers must be contiguous, "
                         f"{align}-byte aligned [{B}, {L}, {KVH}, {D}], got "
                         f"{tuple(t.shape)}")


def kv_ring_write(kbuf: torch.Tensor, vbuf: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, pos) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-place ring write: ``kbuf[:, start + i] = k[:, i]`` and the same
    for V, for i < S, ``start`` as ``dynamic_update_slice`` takes it
    (``pos + L`` for a negative pos, then clamped to ``[0, L - S]``).
    kbuf/vbuf [B, L, KVH, D]; k/v [B, S, KVH, D] (cast to the ring's
    dtype); pos a 0-d int32 tensor on the ring's device.  Returns the
    rings."""
    if kbuf.device.type == "cpu":
        return _ref_ring_write(kbuf, vbuf, k, v, pos)
    name = "kv_ring_write"
    B, L, KVH, D = kbuf.shape
    S = k.shape[1]
    es = kbuf.element_size()
    for t in (kbuf, vbuf):
        _check_ring(name, t, B, L, KVH, D, es)
    k, v = k.to(kbuf.dtype).contiguous(), v.to(kbuf.dtype).contiguous()
    for t in (k, v):
        if tuple(t.shape) != (B, S, KVH, D) or t.data_ptr() % es:
            raise ValueError(f"{name}: new rows must be [{B}, S, {KVH}, "
                             f"{D}], got {tuple(t.shape)}")
    row_bytes = KVH * D * es
    if not 1 <= S <= L:
        raise ValueError(f"{name}: {S} rows do not fit a ring of {L}")
    _check_pos(name, pos, kbuf.device)
    _, stream = _build.launch_args(name, kbuf, vbuf, k, v)
    if B:
        with _build.device_guard(kbuf):
            _build.check(_build.lib().ptt_kv_ring_write(
                kbuf.data_ptr(), vbuf.data_ptr(), k.data_ptr(), v.data_ptr(),
                pos.data_ptr(), B, L, S, row_bytes, stream), name)
        kv_ring_write.launches += 1
    return kbuf, vbuf


def decode_attention(q: torch.Tensor, kbuf: torch.Tensor, vbuf: torch.Tensor,
                     pos, scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over the static KV ring.

    q [B, 1, H, D]; kbuf/vbuf [B, L, KVH, D] (native ring layout, no
    transposes); pos: attend to cols <= pos, a 0-d int32 tensor on the
    ring's device (an int on the CPU).  Returns [B, 1, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return ref_decode_attention(q, kbuf, vbuf, pos, scale)
    return _launch(q, kbuf, vbuf, pos, scale)


def _launch(q, kbuf, vbuf, pos, scale=None, **force):
    """The kernel's launch for CUDA tensors, under ``decode_plan``'s plan
    or one whose ``splits`` is forced."""
    name = "decode_attention"
    B, s, H, D = q.shape
    L, KVH = kbuf.shape[1], kbuf.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    if s != 1 or H % KVH or kbuf.shape[0] != B or kbuf.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit the ring "
                         f"{tuple(kbuf.shape)} (one token, H % KVH == 0)")
    for t in (kbuf, vbuf):
        _check_ring(name, t, B, L, KVH, D)
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"{name}: q must be contiguous and 16-byte aligned")
    _check_pos(name, pos, q.device)
    dt, stream = _build.launch_args(name, q, kbuf, vbuf)
    out = torch.empty_like(q)
    if B:
        plan = _plan(B, L, H, KVH, D, q.dtype, **force)
        with _build.device_guard(q):
            _build.check(_build.lib().ptt_decode_attention(
                q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
                out.data_ptr(), pos.data_ptr(), B, L, H, KVH, D,
                float(scale), plan.splits, dt, stream), name)
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
kv_ring_write.launches = 0
