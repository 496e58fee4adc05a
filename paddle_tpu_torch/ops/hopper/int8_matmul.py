"""Weight-only int8 matrix product — Hopper kernel B7
(``csrc/int8_matmul.cu``).

Port of ``paddle_tpu/ops/pallas/int8_matmul.py``: ``int8_matmul`` replaces
``_int8_mm_impl`` (its ``_kernel``).  ``x [..., K] @ qw [K, N]`` (int8,
per-column float32 ``scale [N]``) ``-> [..., N]`` in x's dtype: the weight
is widened on the chip, the products are summed in float32, and the scale
is applied once, in float32, before the one cast.  ``int8_linear`` adds a
bias ``[N]`` in the kernel's epilogue, rounded as the reference's separate
add (``cast(cast(acc * scale) + bias)``), so its result is
``int8_matmul(...) + bias`` bit for bit.  Bound on the H100 by operations
at the predictor's row counts and by the weight's bytes at a few rows (see
the source's note).

``int8_plan(M, N, K, dtype)`` picks the kernel's kind and tiles from host
sizes only: bfloat16 with N >= 64 runs the wgmma instance over the
transposed product (the token tile is wgmma's N, 8 .. 256; a block takes
64 or 128 weight rows; where the grid would give the card fewer than 132
blocks, a cluster of 2-8 blocks splits K and merges in one launch); N < 64
runs the narrow instance (a warp a row); float32 with N >= 64 the SIMT one.

The kernel takes every shape: there is no shape fallback on CUDA (the
reference falls back to a dequantize-then-matmul in x's dtype where M is not
a multiple of 8 or K or N not of 128; on those shapes the two differ by
rounding only) and no pad of M to 8 rows (a TPU sublane detail).  Rows of x
are read with their own stride: the classifier head's ``x[:, 0]`` is passed
as it is, without a copy; a column stride other than 1 is made contiguous.

For CPU tensors the wrappers run the plain version (``_int8_matmul_ref``:
``(x.float() @ qw.float()) * scale`` cast to x's dtype, then ``+ bias`` in
that dtype); for CUDA tensors they launch the kernel or raise.  An x other
than float32 or bfloat16, or a qw other than int8, raises on either device.
``int8_matmul.launches`` counts kernel launches (one per call of either
wrapper), ``int8_matmul.bias_launches`` those that added a bias in the
epilogue.  The forward is the ``torch.library`` op
``paddle_tpu_torch::int8_linear`` (the plan and the addresses are read in
its real implementation; its fake one gives the output's shape), so an
exported program keeps the call.  The gradient flows to x, ``dx = g @
(qw * scale)^T`` in g's dtype, plain torch as the reference's jnp
backward, and to the bias, ``g`` summed over rows; qw and scale get none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import _build

__all__ = ["int8_matmul", "int8_linear", "int8_plan", "Int8Plan"]

_X_DTYPES = (torch.float32, torch.bfloat16)

SMS = 132                 # the H100's streaming multiprocessors
K_STEP = 64               # k per ring stage of the wgmma instance
TILES = (8, 16, 32, 64, 128, 256)   # token tiles (wgmma N) compiled
ROWS = (64, 128)          # weight rows a block takes: 1 or 2 warpgroups
SPLITS = (1, 2, 4, 8)     # cluster sizes
NARROW_N = 64             # below this many output columns: the narrow kind
NARROW_WARPS = 8          # warps of a narrow block, 1-8 to a row of x
SIMT_TILE = 64            # the float32 SIMT instance's square tile
KINDS = {"wgmma": 0, "narrow": 1, "simt": 2}   # the C entry's codes


def _narrow_rows(K: int, dtype: torch.dtype) -> int:
    """Rows of x a narrow block takes (``narrow_warps`` in the source):
    1-8 warps share a row, as many as give each lane about one 16-byte
    piece of it."""
    per_load = 8 if dtype == torch.bfloat16 else 4
    w = 1
    while w < NARROW_WARPS and 32 * w * per_load < K:
        w *= 2
    return NARROW_WARPS // w


def _stages(tile: int) -> int:
    """Ring depth of the wgmma instance (``stages_for`` in the source)."""
    return 8 if tile <= 32 else 6 if tile <= 64 else 4


def _smem(tile: int, rows: int) -> int:
    """Dynamic shared memory of a wgmma block (``Tile::kSmem``): the ring,
    or the staged output tile, or a split's float32 partials, and 1024
    bytes of alignment."""
    ring = _stages(tile) * (tile * 128 + K_STEP * rows)
    staged = tile * (2 * rows + 16)
    partials = tile // 2 * (2 * rows) * 4
    return max(ring, staged, partials) + 1024


def _split_ok(KT: int, splits: int) -> bool:
    """The plan's own splits: every split takes at least 4 steps of 64 and
    the last is not empty."""
    chunk = -(-KT // splits)
    return chunk >= 4 and (splits - 1) * chunk < KT


@dataclass(frozen=True)
class Int8Plan:
    """One B7 launch: ``kind`` (``wgmma``, ``narrow`` or ``simt``),
    ``tile`` token rows and ``rows`` output columns a block takes,
    ``splits`` blocks of a cluster sharing K (``chunk`` steps of 64 each),
    the ring's ``stages``, the grid's ``blocks`` (splits included) and a
    block's dynamic shared memory ``smem`` (bytes)."""

    kind: str
    tile: int
    rows: int
    splits: int
    chunk: int
    stages: int
    blocks: int
    smem: int


def int8_plan(M: int, N: int, K: int, dtype: torch.dtype, *,
              kind: Optional[str] = None, tile: Optional[int] = None,
              rows: Optional[int] = None,
              splits: Optional[int] = None) -> Int8Plan:
    """The B7 launch for x [M, K] @ qw [K, N] in ``dtype``, from host sizes
    only.  The keywords force a choice (``chip_smoke.py``'s edges and
    ``--b7-sweep``); a forced plan the instances do not take raises
    ``ValueError``.

    bfloat16, N >= 64: the token tile is the smallest compiled one holding
    M rows up to 128, else 128; a block takes 128 weight rows where the
    grid then still gives every SM a block, else 64; K is split (2, 4, 8)
    until the grid reaches 132 blocks, while every split keeps at least 4
    steps of 64 and the last one is not empty."""
    if dtype not in _X_DTYPES:
        raise ValueError(f"int8_plan: float32 or bfloat16, got {dtype}"
                         f"{_build.f16_note(dtype)}")
    if M < 1 or N < 1 or K < 0:
        raise ValueError(f"int8_plan: M, N >= 1 and K >= 0, got {M}, {N}, "
                         f"{K}")
    KT = -(-K // K_STEP)
    if kind is None:
        kind = ("narrow" if N < NARROW_N else
                "wgmma" if dtype == torch.bfloat16 else "simt")
    if kind == "narrow" or kind == "simt":
        if kind == "simt" and dtype != torch.float32:
            raise ValueError("int8_plan: the SIMT instance is float32's")
        if splits not in (None, 1):
            raise ValueError(f"int8_plan: the {kind} instance does not "
                             "split K")
        if kind == "narrow":
            rows_x = _narrow_rows(K, dtype)
            return Int8Plan("narrow", rows_x, N, 1, KT, 0, -(-M // rows_x),
                            0)
        return Int8Plan("simt", SIMT_TILE, SIMT_TILE, 1, KT, 0,
                        -(-M // SIMT_TILE) * -(-N // SIMT_TILE), 0)
    if kind != "wgmma" or dtype != torch.bfloat16:
        raise ValueError(f"int8_plan: kind {kind!r} for {dtype}")
    if tile is None:
        tile = next(t for t in TILES if t >= min(M, 128))
    m_blocks = -(-M // tile)
    if rows is None:
        rows = 128 if -(-N // 128) * m_blocks >= SMS else 64
    blocks = -(-N // rows) * m_blocks
    if splits is None:
        splits = 1
        while (splits < SPLITS[-1] and blocks * splits < SMS
               and _split_ok(KT, 2 * splits)):
            splits *= 2
    if tile not in TILES or rows not in ROWS or splits not in SPLITS:
        raise ValueError(f"int8_plan: no instance for tile {tile}, rows "
                         f"{rows}, splits {splits}")
    chunk = KT if splits == 1 else -(-KT // splits)
    if splits > 1 and (splits - 1) * chunk >= KT:
        raise ValueError(f"int8_plan: {splits} splits of {KT} K steps "
                         "leave one empty")
    if -(-N // rows) > 65535 or m_blocks > 65535:
        raise ValueError(f"int8_plan: grid past 65535 for M {M}, N {N}")
    return Int8Plan("wgmma", tile, rows, splits, chunk, _stages(tile),
                    blocks * splits, _smem(tile, rows))


def _int8_matmul_ref(x2, qw, scale, bias=None):
    """The plain version on [M, K] x [K, N]: float32 sums, the scale once
    after them, one cast to x's dtype, then the bias added in that dtype
    (the reference's separate add)."""
    out = ((x2.float() @ qw.float()) * scale).to(x2.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _check(x, qw, scale, bias=None):
    name = "int8_matmul"
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}{_build.f16_note(x.dtype)}")
    if qw.dtype != torch.int8:
        raise TypeError(f"{name}: qw must be int8, got {qw.dtype}")
    if qw.dim() != 2 or x.shape[-1] != qw.shape[0]:
        raise ValueError(f"{name}: x [..., K] and qw [K, N] expected, got "
                         f"{tuple(x.shape)} and {tuple(qw.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (qw.shape[1],):
        raise ValueError(f"{name}: scale must be float32 [{qw.shape[1]}], "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if not (qw.is_contiguous() and scale.is_contiguous()):
        raise ValueError(f"{name}: qw and scale must be contiguous")
    if not x.device == qw.device == scale.device:
        raise ValueError(f"{name}: x, qw and scale must share one device, "
                         f"got {x.device}, {qw.device}, {scale.device}")
    if bias is not None:
        if not bias.is_floating_point() or tuple(bias.shape) != (
                qw.shape[1],):
            raise ValueError(f"{name}: bias must be floating [{qw.shape[1]}]"
                             f", got {bias.dtype} {tuple(bias.shape)}")
        if bias.device != x.device:
            raise ValueError(f"{name}: bias on {bias.device}, x on "
                             f"{x.device}")


def _launch(x2, qw, scale, bias=None, **force):
    """Kernel B7 on x2 [M, K] (unit column stride) -> [M, N], under
    ``int8_plan`` (``force``: its keywords)."""
    name = "int8_matmul"
    M, K = x2.shape
    N = qw.shape[1]
    out = torch.empty((M, N), dtype=x2.dtype, device=x2.device)
    if M and N:
        plan = int8_plan(M, N, K, x2.dtype, **force)
        # the bias in the output's dtype, as the two-step add casts it
        b = None if bias is None else bias.to(x2.dtype).contiguous()
        dt, stream = _build.launch_args(name, x2)
        with _build.device_guard(x2):
            _build.check(_build.lib().ptt_int8_matmul(
                x2.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                None if b is None else b.data_ptr(), out.data_ptr(), M, N, K,
                x2.stride(0), KINDS[plan.kind], plan.tile, plan.rows,
                plan.splits, dt, stream), name)
        int8_matmul.launches += 1
        if b is not None:
            int8_matmul.bias_launches += 1
    return out


@_build.kernel_op("int8_linear(Tensor x, Tensor qw, Tensor scale, "
                  "Tensor? bias) -> Tensor",
                  fake=lambda x, qw, scale, bias: x.new_empty(
                      (*x.shape[:-1], qw.shape[1])))
def _forward(x, qw, scale, bias):
    K, N = qw.shape
    x2 = x.reshape(-1, K)          # a view where the layout allows one
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    if x.device.type == "cpu":
        out = _int8_matmul_ref(x2, qw, scale, bias)
    else:
        out = _launch(x2, qw, scale, bias)
    return out.reshape(*x.shape[:-1], N)


class _Int8Linear(torch.autograd.Function):
    """B7 forward (bias in the epilogue); the backward to x through the
    dequantized weight, as the reference's ``_int8_mm_bwd``, and to the
    bias, ``g`` summed over rows, as the reference's separate add."""

    @staticmethod
    def forward(ctx, x, qw, scale, bias):
        ctx.save_for_backward(qw, scale)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _forward(x, qw, scale, bias)

    @staticmethod
    def backward(ctx, g):
        qw, scale = ctx.saved_tensors
        dx = db = None
        if ctx.needs_input_grad[0]:
            w = qw.to(g.dtype) * scale.to(g.dtype)[None, :]
            dx = g @ w.t()
        if ctx.bias_dtype is not None and ctx.needs_input_grad[3]:
            db = g.reshape(-1, g.shape[-1]).sum(0).to(ctx.bias_dtype)
        return dx, None, None, db


def int8_linear(x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``int8_matmul(x, qw, scale) + bias`` in one launch: the bias [N]
    (cast to x's dtype) is added in B7's epilogue with the two-step
    rounding.  Differentiable in x and the bias."""
    _check(x, qw, scale, bias)
    if _build.wants_grad(x, *(() if bias is None else (bias,))):
        return _Int8Linear.apply(x, qw, scale, bias)
    return _forward(x, qw, scale, bias)


def int8_matmul(x: torch.Tensor, qw: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] (float32 or bfloat16) @ qw [K, N] int8 * scale [N]
    float32 -> [..., N] in x's dtype.  Differentiable in x."""
    return int8_linear(x, qw, scale)


int8_matmul.launches = 0
int8_matmul.bias_launches = 0
