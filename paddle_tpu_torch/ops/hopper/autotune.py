"""Flash-attention tile selection for the Hopper kernels B1 and B8.

Port of ``paddle_tpu/ops/pallas/autotune.py``: ``get_flash_blocks`` picks
the (block_q, block_k) tiling of the flash kernels from a table keyed like
the reference's, ``tune()`` measures every compiled instance on the card,
and the measured choices live in a process cache persisted to the file
named by ``PADDLE_TPU_AUTOTUNE_CACHE``.  ``_pick_block`` and
``_bucket_seq`` are the reference's.

What differs from the reference:

* The tiles are not free: each (kind, head-dim class, tile pair) is a
  compiled instance of ``csrc/flash_attention.cu`` (forward) or
  ``csrc/flash_attention_bwd.cu`` (backward), listed in ``INSTANCES``, the
  mirror of the C dispatch tables.  ``get_flash_blocks`` only ever returns a
  listed pair; the C side refuses any other.  The head-dim class is D
  rounded up to 64, 128, 256 or 512 (the tensor-core tiles are 64 columns
  wide; columns past D are zero-filled).  Class 512 (every D past 256) has
  no tensor-core instance: the SIMT instances with the ``SIMT_TILES`` pair
  serve bfloat16 there too (rows held whole up to ``MAX_HEAD_DIM``, the
  wide instances past it streaming the head dim in chunks), their pair
  listed here so the table covers every class the reference's
  ``_DEFAULT_TARGETS`` has.
* Ragged edges are masked in the kernels, so ``_pick_block`` caps a tile at
  the sequence's power-of-two bucket (never a tile taller than the
  sequence) instead of snapping to a divisor.
* The table is for the bfloat16 tensor-core instances.  float32 runs on the
  SIMT instances, one tile pair each (``SIMT_TILES``).
* ``_DEFAULT_TARGETS`` are this port's own H100 measurements (see the
  comment there); none of the reference's TPU-measured targets carry over.
* A cache file that cannot be used is an error, where the reference
  passes over it: a corrupt or unreadable file raises on every
  ``get_flash_blocks`` call (the file counts as read only after a read
  that succeeds), and ``_save_cache`` raises on a path it cannot write.
  Both errors name the file.
* The reference's on-line branch (``FLAGS_flash_autotune`` timing every
  candidate on first encounter of a shape) is not ported: the port has no
  flags module yet.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Tuple

__all__ = ["get_flash_blocks", "tune", "clear_cache", "INSTANCES",
           "SIMT_TILES", "head_dim_class", "MAX_HEAD_DIM"]

Pair = Tuple[int, int]

# the compiled bfloat16 tensor-core instances: (kind, head-dim class) ->
# (block_q, block_k) pairs.  Forward: 64 query rows per consumer warpgroup,
# 64-key tiles.  Backward: 64 query rows a tile, 64 keys per warpgroup, one
# or two warpgroups a block (D 256: two on one 64-key tile).  A pair is here
# when some measured shape picks it: 128-key forward tiles and the D 64
# alternates won none (PERF.md) and are not compiled.
INSTANCES: Dict[Tuple[str, int], Tuple[Pair, ...]] = {
    ("fwd", 64): ((64, 64),),
    ("fwd", 128): ((128, 64), (64, 64)),
    ("fwd", 256): ((128, 64), (64, 64)),
    ("bwd", 64): ((64, 64),),
    ("bwd", 128): ((64, 128), (64, 64)),
    ("bwd", 256): ((64, 64),),
    # the SIMT instances past 256 columns, bfloat16 and float32 alike
    ("fwd", 512): ((32, 32),),
    ("bwd", 512): ((16, 16),),
}

# the float32 SIMT instances' single tile pair, by kind and head dim
SIMT_TILES = {
    "fwd": lambda d: (64, 64) if d <= 256 else (32, 32),
    "bwd": lambda d: (64, 64) if d <= 128 else (32, 32) if d <= 256
    else (16, 16),
}

# Targets by (kind, head-dim class): the fastest compiled pair in
# chip_smoke.py phase 2's tile sweep (tune() at seq 512 and 2048, and every
# pair at the training shapes [8, 2048, 20 | 10 heads]) on an NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit; the times are in PERF.md.
# get_flash_blocks caps a target at the sequence's bucket (64 below 128
# rows) and at the compiled pairs.
_DEFAULT_TARGETS: Dict[Tuple[str, int], Pair] = {
    ("fwd", 64): (64, 64),
    ("fwd", 128): (128, 64),
    ("fwd", 256): (128, 64),
    ("bwd", 64): (64, 64),
    ("bwd", 128): (64, 128),
    ("bwd", 256): (64, 64),
    # the one SIMT pair of class 512 (not measured against others)
    ("fwd", 512): (32, 32),
    ("bwd", 512): (16, 16),
}

# the widest head the SIMT instances hold whole; past it the wide
# instances stream the head dim (the same tile pairs)
MAX_HEAD_DIM = 512

_MIN_TILE = 64  # a wgmma covers 64 rows

# process-level measured cache: (kind, sq_bucket, sk_bucket, d) -> (bq, bk)
_measured: Dict[Tuple, Pair] = {}
_cache_loaded = False


def _pick_block(s: int, target: int) -> int:
    b = min(target, s)
    while s % b:
        b //= 2
    return max(b, 1)


def _bucket_seq(s: int) -> int:
    """Round down to a power of two (tables are per-magnitude, not per-shape)."""
    b = 1
    while b * 2 <= s:
        b *= 2
    return b


def head_dim_class(d: int) -> int:
    """The instance class of head dim ``d``: 64, 128 or 256 (the
    tensor-core column widths), 512 for every D past 256."""
    if d <= 0:
        raise ValueError(f"head_dim {d}: the flash kernels take head dims "
                         "of 1 or more")
    return 64 if d <= 64 else 128 if d <= 128 else 256 if d <= 256 else 512


def _cache_path():
    return os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE")


def _load_cache():
    """Read the cache file once.  The file counts as read only after a
    read that succeeds: a corrupt or unreadable file raises on this call
    and on every later one, naming the file."""
    global _cache_loaded
    if _cache_loaded:
        return
    p = _cache_path()
    if p and os.path.exists(p):
        try:
            with open(p) as f:
                entries = {tuple(json.loads(k)): tuple(v)
                           for k, v in json.load(f).items()}
        except (OSError, ValueError, TypeError, AttributeError) as e:
            raise RuntimeError(f"flash tile cache {p!r} (named by "
                               f"PADDLE_TPU_AUTOTUNE_CACHE) cannot be read: "
                               f"{e}") from e
        _measured.update(entries)
    _cache_loaded = True


def _save_cache():
    p = _cache_path()
    if not p:
        return
    try:
        with open(p, "w") as f:
            json.dump({json.dumps(list(k)): list(v)
                       for k, v in _measured.items()}, f)
    except OSError as e:
        raise RuntimeError(f"flash tile cache {p!r} (named by "
                           f"PADDLE_TPU_AUTOTUNE_CACHE) cannot be written: "
                           f"{e}") from e


def clear_cache():
    _measured.clear()


def _snap(kind: str, dc: int, sq: int, sk: int, target: Pair) -> Pair:
    """The largest compiled pair within ``target`` capped at the
    sequences' buckets (at least one 64-row tile), else the smallest."""
    cap_q = _pick_block(max(_MIN_TILE, _bucket_seq(sq)), target[0])
    cap_k = _pick_block(max(_MIN_TILE, _bucket_seq(sk)), target[1])
    pairs = INSTANCES[(kind, dc)]
    fit = [p for p in pairs if p[0] <= cap_q and p[1] <= cap_k]
    return max(fit) if fit else min(pairs)


def get_flash_blocks(kind: str, sq: int, sk: int, d: int) -> Pair:
    """Block sizes for the bfloat16 flash kernel. kind: 'fwd' | 'bwd'.
    Always a pair of ``INSTANCES[(kind, head_dim_class(d))]``."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"kind must be 'fwd' or 'bwd', got {kind!r}")
    _load_cache()
    dc = head_dim_class(d)
    hit = _measured.get((kind, _bucket_seq(sq), _bucket_seq(sk), d))
    return _snap(kind, dc, sq, sk,
                 hit if hit is not None else _DEFAULT_TARGETS[(kind, dc)])


def _time_pair(kind: str, pair: Pair, s: int, d: int, n_iter: int) -> float:
    """Mean CUDA-event ms of one causal bf16 call at tiles ``pair``."""
    import torch

    from . import flash_attention as fa

    heads = 16
    batch = max(1, 8192 // s)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v, go = (torch.randn(batch, s, heads, d, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    if kind == "fwd":
        def fn():
            fa.flash_attention_fused(q, k, v, True, blocks=pair)
    else:
        o, lse = fa.flash_attention_fused(q, k, v, True)

        def fn():
            fa.flash_attention_bwd_fused(q, k, v, o, lse, go, True,
                                         blocks=pair)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def tune(seqs: Iterable[int] = (512, 2048, 4096),
         head_dims: Iterable[int] = (64, 128, 256), n_iter: int = 10,
         verbose: bool = True) -> Dict[Tuple[str, int, int], Pair]:
    """Time every compiled instance with CUDA events on the card (bf16,
    causal, 16 heads, ~8192 rows) for each (kind, seq, head_dim); return the
    fastest pairs (also filling the process cache, persisted when
    ``PADDLE_TPU_AUTOTUNE_CACHE`` is set)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("tune() times the kernels on a CUDA device")
    out = {}
    for d in head_dims:
        dc = head_dim_class(d)
        for s in seqs:
            for kind in ("fwd", "bwd"):
                times = {p: _time_pair(kind, p, s, d, n_iter)
                         for p in INSTANCES[(kind, dc)]}
                best = min(times, key=times.get)
                _measured[(kind, _bucket_seq(s), _bucket_seq(s), d)] = best
                out[(kind, s, d)] = best
                if verbose:
                    print(f"tune {kind} seq={s} d={d}: " + ", ".join(
                        f"{p[0]}x{p[1]} {t:.4f} ms"
                        for p, t in times.items())
                        + f" -> block_q={best[0]} block_k={best[1]}",
                        flush=True)
    _save_cache()
    return out
