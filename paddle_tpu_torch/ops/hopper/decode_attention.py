"""Decode attention over the static KV ring and the in-place ring write —
Hopper kernels B2 and B3 (``csrc/decode_attention.cu``).

Port of ``paddle_tpu/ops/pallas/decode_attention.py``:
``decode_attention`` replaces ``decode_attention`` (``_decode_kernel``):
one query token per row against the ring ``[B, L, KVH, D]`` in its native
layout, columns ``<= pos``; ``kv_ring_write`` replaces ``kv_ring_write``:
the step's rows written into the ring in place.  Both read ``pos`` from
device memory, so a decode loop needs no host sync.  Both are bound on the
H100 by bytes (see the source's note).

Beside the reference, ``kv_ring_write`` writes the K and the V ring in one
launch and takes ``S >= 1`` rows at ``pos .. pos + S - 1`` (the static
prefill), with the start clamped to ``[0, L - S]`` as
``dynamic_update_slice`` clamps it.

A wrapper runs the plain version (``ref_decode_attention``, the
reference's jnp reference transcribed; ``_ref_ring_write``, an
``index_copy_``) only for CPU tensors.  For CUDA tensors it launches the
kernel or raises; ``launches`` counts wrapper calls that launched.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build

__all__ = ["ref_decode_attention", "decode_attention", "kv_ring_write"]

NEG_INF = -1e30
# keys per block of the decode kernel (a chunk of the ring); the C entry
# derives the same chunk count from it
_CHUNK = 256


def ref_decode_attention(q, kbuf, vbuf, pos, scale: Optional[float] = None):
    """q [B, 1, H, D], kbuf/vbuf [B, L, KVH, D], pos (int or 0-d tensor):
    attend to cols <= pos with a float32 softmax -> [B, 1, H, D]."""
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
    return o.transpose(1, 2).to(q.dtype)


def _ref_ring_write(kbuf, vbuf, k, v, pos):
    S, L = k.shape[1], kbuf.shape[1]
    # dynamic_update_slice's start: pos clamped to [0, L - S]
    start = torch.clamp(torch.as_tensor(pos, device=kbuf.device), 0, L - S)
    rows = start.long() + torch.arange(S, device=kbuf.device)
    kbuf.index_copy_(1, rows, k.to(kbuf.dtype))
    vbuf.index_copy_(1, rows, v.to(vbuf.dtype))
    return kbuf, vbuf


def _check_pos(name, pos, device):
    if not (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32
            and pos.numel() == 1 and pos.device == device):
        raise ValueError(f"{name}: pos must be one int32 on {device}")


def _check_ring(name, t, B, L, KVH, D):
    if (tuple(t.shape) != (B, L, KVH, D) or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: ring buffers must be contiguous, 16-byte "
                         f"aligned [{B}, {L}, {KVH}, {D}], got "
                         f"{tuple(t.shape)}")


def kv_ring_write(kbuf: torch.Tensor, vbuf: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, pos) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-place ring write: ``kbuf[:, start + i] = k[:, i]`` and the same
    for V, for i < S, ``start = clamp(pos, 0, L - S)``.  kbuf/vbuf
    [B, L, KVH, D]; k/v [B, S, KVH, D] (cast to the ring's dtype); pos a
    0-d int32 tensor on the ring's device.  Returns the rings."""
    if kbuf.device.type == "cpu":
        return _ref_ring_write(kbuf, vbuf, k, v, pos)
    name = "kv_ring_write"
    B, L, KVH, D = kbuf.shape
    S = k.shape[1]
    for t in (kbuf, vbuf):
        _check_ring(name, t, B, L, KVH, D)
    k, v = k.to(kbuf.dtype).contiguous(), v.to(kbuf.dtype).contiguous()
    for t in (k, v):
        if tuple(t.shape) != (B, S, KVH, D) or t.data_ptr() % 16:
            raise ValueError(f"{name}: new rows must be 16-byte aligned "
                             f"[{B}, S, {KVH}, {D}], got {tuple(t.shape)}")
    row_bytes = KVH * D * kbuf.element_size()
    if not 1 <= S <= L or row_bytes % 16:
        raise ValueError(f"{name}: {S} rows do not fit a ring of {L}, or a "
                         "row is not a multiple of 16 bytes")
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
    B, s, H, D = q.shape
    L, KVH = kbuf.shape[1], kbuf.shape[2]
    scale = scale or 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return ref_decode_attention(q, kbuf, vbuf, pos, scale)
    name = "decode_attention"
    if s != 1 or H % KVH or kbuf.shape[0] != B or kbuf.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit the ring "
                         f"{tuple(kbuf.shape)} (one token, H % KVH == 0)")
    if D % 16 or D > 256:
        raise ValueError(f"{name}: head_dim {D} must be a multiple of 16 "
                         "and <= 256")
    for t in (kbuf, vbuf):
        _check_ring(name, t, B, L, KVH, D)
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    _check_pos(name, pos, q.device)
    dt, stream = _build.launch_args(name, q, kbuf, vbuf)
    out = torch.empty_like(q)
    n_split = -(-L // _CHUNK)
    part_acc = part_ml = None
    if n_split > 1:
        part_acc = torch.empty((B * H * n_split * D,), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B * H * n_split * 2,), dtype=torch.float32,
                              device=q.device)
    if B:
        with _build.device_guard(q):
            _build.check(_build.lib().ptt_decode_attention(
                q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
                out.data_ptr(),
                None if part_acc is None else part_acc.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(),
                pos.data_ptr(), B, L, H, KVH, D, _CHUNK, float(scale), dt,
                stream), name)
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
kv_ring_write.launches = 0
