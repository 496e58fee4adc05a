"""The wide instances' sizes (Queue C8), the mirror of
``csrc/wide_attention.cuh``: past ``MAX_HEAD_DIM`` (512) columns B1, B2
and K4 walk the keys with the head dim streamed through shared memory in
chunks, each block writing one slice of at most 512 output columns.  The
plans of ``decode_attention.py`` and ``paged_attention.py`` take a block's
shared memory and its slices from here."""
from __future__ import annotations

__all__ = ["MAX_HEAD_DIM", "KEYS", "slice_cols", "smem_bytes"]

MAX_HEAD_DIM = 512      # the widest head the whole-row instances take
KEYS = 32               # keys a tile (csrc kKeys)
_THREADS = 128          # csrc kThreads
_CHUNK = 64             # columns of Q and K staged at a time (csrc kChunk)
_PER = 8                # scores a thread sums in a pass (csrc kPer)
_PASS_ROWS = _THREADS * _PER // KEYS
_SMEM_LIMIT = 232448    # the 227 KB a block may use


def smem_bytes(R: int, W: int) -> int:
    """Shared memory of a block of R query rows and a W-column slice
    (csrc ``smem_bytes``)."""
    return 4 * (_PASS_ROWS * _CHUNK + KEYS * (_CHUNK + 1) + R * KEYS
                + KEYS * W + R * W + 3 * R)


def slice_cols(R: int, D: int) -> int:
    """The slice width (csrc ``slice_cols``): the fewest slices of at most
    512 columns whose block fits 227 KB, as even as multiples of 8 allow;
    0 where not even 8 columns fit."""
    W = min(MAX_HEAD_DIM, -(-D // 8) * 8)
    while W > 0 and smem_bytes(R, W) > _SMEM_LIMIT:
        W -= 8
    if not W:
        return 0
    ns = -(-D // W)
    return -(-D // (8 * ns)) * 8
