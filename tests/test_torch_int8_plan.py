"""Kernel B7's plan, its division of work and its bias epilogue, on the CPU.

``int8_plan`` (``paddle_tpu_torch/ops/hopper/int8_matmul.py``) picks B7's
kind, token tile, weight rows a block and K split from host sizes.  These
tests hold, over M 1-4097, N 1-11008 and K 1-4096 (hypothesis) and at the
predictor's, the decode's, the head's and phase 2's odd shapes, that the
grid covers every output element once and every K step once, that every
plan names an instance the source compiles (its dispatch is read from
``csrc/int8_matmul.cu``) within the 227 KB of shared memory a block may
use, and the plan's choices at the paths' shapes.  A plain-torch emulation
of the plan's tiling and split-K sums (float32 partials, merged in split
order, as the cluster's leader adds them) is held against the plain version
and against the reference's ``int8_matmul(interpret=True)``; the bias
path is held bit for bit against the two-step add, and the gradients of x
and the bias against ``jax.grad`` of the reference's composition
(``weight_only_linear``: the product, then the bias added).

Tolerances: the emulation against the plain version, float32 1e-5 of the
largest |out| (the same products summed in another order); against the
reference, the existing B7 test's (float32 1e-5; bfloat16 one bf16 ulp,
2^-7 relative, where both round one float32 sum; 2^-6 of the largest |out|
at the reference's fallback shapes, where it scales in bf16 first).
"""
import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from paddle_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul
from paddle_tpu_torch.ops.hopper import int8_matmul as im
from paddle_tpu_torch.quantization import weight_only_linear

torch.set_num_threads(2)

BF = torch.bfloat16
SMEM_LIMIT = 232448          # bytes of shared memory a block may use
SRC = os.path.join(os.path.dirname(im.__file__), "..", "..", "csrc",
                   "int8_matmul.cu")


def _compiled():
    """The token tiles, weight rows and split counts the source's dispatch
    and ``valid_plan`` take."""
    src = open(SRC).read()
    tiles = {int(t) for t in re.findall(r"case (\d+): return launch_tc<", src)}
    rows = {int(r) for r in re.findall(r"rows == (\d+)", src)}
    splits = {1, 2, 4, int(re.search(r"kMaxSplits = (\d+)", src).group(1))}
    return tiles, rows, splits


def _cover(n, size, count):
    """How often each of n positions is taken by `count` ranges of
    `size`."""
    hits = np.zeros(n, np.int64)
    for i in range(count):
        hits[i * size:min(n, (i + 1) * size)] += 1
    return hits


def _check_plan(p, M, N, K, dtype):
    KT = -(-K // im.K_STEP)
    if p.kind == "narrow":
        assert N < im.NARROW_N and p.splits == 1 and p.rows == N
        assert (_cover(M, p.tile, p.blocks) == 1).all()
        return
    if p.kind == "simt":
        assert dtype == torch.float32 and p.splits == 1
        assert p.blocks == -(-M // p.tile) * -(-N // p.rows)
        return
    tiles, rows, splits = _compiled()
    assert dtype == BF
    assert p.tile in tiles and p.rows in rows and p.splits in splits
    assert set(im.TILES) == tiles and set(im.ROWS) == rows
    assert p.smem <= SMEM_LIMIT and p.stages >= 2 * (p.rows // 64)
    m_blocks, n_blocks = -(-M // p.tile), -(-N // p.rows)
    assert p.blocks == m_blocks * n_blocks * p.splits
    assert m_blocks <= 65535 and n_blocks <= 65535
    assert (_cover(M, p.tile, m_blocks) == 1).all()
    assert (_cover(N, p.rows, n_blocks) == 1).all()
    # the splits' K steps: disjoint, every step once, none empty
    steps = _cover(KT, p.chunk, p.splits)
    assert (steps == 1).all()
    assert p.splits == 1 or (p.splits - 1) * p.chunk < KT


@settings(max_examples=300, deadline=None, database=None)
@given(M=st.integers(1, 4097), N=st.integers(1, 11008),
       K=st.integers(1, 4096), bf16=st.booleans())
def test_plan_covers_every_output_and_k_step_once(M, N, K, bf16):
    dtype = BF if bf16 else torch.float32
    p = im.int8_plan(M, N, K, dtype)
    assert (p.kind == "narrow") == (N < im.NARROW_N)
    _check_plan(p, M, N, K, dtype)


SHAPES = [(4096, 768, 768), (4096, 3072, 768), (4096, 768, 3072),
          (32, 2, 768), (8, 11008, 4096), (3, 130, 100), (64, 144, 100),
          (1, 64, 64), (9, 130, 4096), (65, 2, 100), (4097, 130, 100)]


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_plan_at_the_paths_and_edge_shapes(M, N, K):
    for dtype in (BF, torch.float32):
        _check_plan(im.int8_plan(M, N, K, dtype), M, N, K, dtype)
    # every forced wgmma plan the instances take (chip_smoke's edges and
    # --b7-sweep) covers the same way
    forced = 0
    for tile in im.TILES:
        for rows in im.ROWS:
            for splits in im.SPLITS:
                try:
                    p = im.int8_plan(M, N, K, BF, kind="wgmma", tile=tile,
                                     rows=rows, splits=splits)
                except ValueError:
                    continue
                _check_plan(p, M, N, K, BF)
                forced += 1
    assert forced >= len(im.TILES) * len(im.ROWS)


def test_plan_choices():
    """The predictor's products take 128-token tiles and 128 weight rows
    (192 and 768 blocks, no split); the decode-sized product takes the
    8-token tile and 64 weight rows (172 blocks, no split); the head and
    any N < 64 run the narrow kind; a 9-row product over 130 columns and
    K 4096 (6 blocks) splits K in 8; float32 runs SIMT."""
    p = im.int8_plan(4096, 768, 768, BF)
    assert (p.kind, p.tile, p.rows, p.splits, p.blocks) == (
        "wgmma", 128, 128, 1, 192)
    assert im.int8_plan(4096, 3072, 768, BF).blocks == 768
    d = im.int8_plan(8, 11008, 4096, BF)
    assert (d.tile, d.rows, d.splits, d.blocks) == (8, 64, 1, 172)
    assert im.int8_plan(32, 2, 768, BF).kind == "narrow"
    assert im.int8_plan(32, 63, 768, torch.float32).kind == "narrow"
    s = im.int8_plan(9, 130, 4096, BF)
    assert (s.tile, s.rows, s.splits, s.chunk) == (16, 64, 8, 8)
    assert im.int8_plan(4096, 768, 768, torch.float32).kind == "simt"
    with pytest.raises(ValueError):
        im.int8_plan(8, 256, 100, BF, splits=4)      # 2 K steps, 4 splits
    with pytest.raises(ValueError):
        im.int8_plan(8, 256, 100, BF, tile=24)
    with pytest.raises(ValueError):
        im.int8_plan(8, 256, 100, torch.float32, kind="wgmma")


def _emulate(x2, qw, scale, bias, p):
    """The plan's tiles and split-K sums in plain torch: each split's
    float32 partial over its K steps, added in split order, then the
    scale, one cast and the bias in x's dtype."""
    M, K = x2.shape
    N = qw.shape[1]
    out = torch.empty(M, N, dtype=x2.dtype)
    KT = -(-K // im.K_STEP)
    for m0 in range(0, M, p.tile):
        for n0 in range(0, N, p.rows):
            ms, ns = slice(m0, m0 + p.tile), slice(n0, n0 + p.rows)
            acc = None
            for s in range(p.splits):
                t0, t1 = s * p.chunk, min(KT, (s + 1) * p.chunk)
                ks = slice(t0 * im.K_STEP, min(K, t1 * im.K_STEP))
                part = x2[ms, ks].float() @ qw[ks, ns].float()
                acc = part if acc is None else acc + part
            y = (acc * scale[ns]).to(x2.dtype)
            if bias is not None:
                y = y + bias[ns].to(y.dtype)
            out[ms, ns] = y
    return out


def _inputs(rng, M, N, K, npdt=np.float32):
    x = rng.standard_normal((M, K)).astype(np.float32).astype(npdt)
    w = rng.standard_normal((K, N)).astype(np.float32)
    s = (np.maximum(np.abs(w).max(0), 1e-9) / 127.0).astype(np.float32)
    q = np.clip(np.round(w / s), -128, 127).astype(np.int8)
    b = rng.standard_normal(N).astype(np.float32).astype(npdt)
    return x, q, s, b


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("M,N,K,force", [
    (16, 256, 512, {}),                              # the Pallas kernel
    (16, 256, 2048, {"splits": 4}),                  # cluster of 4
    (24, 128, 1024, {"tile": 8, "splits": 2}),       # 3 token tiles
    (9, 130, 100, {}),                               # the fallback's shape
    (65, 144, 1000, {"tile": 64, "rows": 128, "splits": 2}),
])
def test_emulated_tiles_and_splits_match_plain_and_reference(M, N, K, force):
    rng = np.random.default_rng(M * 7 + K)
    x, q, s, _ = _inputs(rng, M, N, K)
    p = im.int8_plan(M, N, K, BF, **force)
    xt, qt, st_ = _torch(x), torch.from_numpy(q), torch.from_numpy(s)
    emu = _emulate(xt, qt, st_, None, p).numpy()
    plain = im._int8_matmul_ref(xt, qt, st_).numpy()
    big = np.abs(plain).max()
    np.testing.assert_allclose(emu, plain, rtol=0, atol=1e-5 * big)
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                     jnp.asarray(s), interpret=True))
    np.testing.assert_allclose(emu, ref, rtol=1e-5, atol=1e-5 * big)
    # the same tiling in bfloat16, against the reference in bfloat16
    xb = x.astype(ml_dtypes.bfloat16)
    emu_b = _emulate(_torch(xb), qt, st_, None, p).float().numpy()
    ref_b = np.asarray(jax_int8_matmul(jnp.asarray(xb), jnp.asarray(q),
                                       jnp.asarray(s), interpret=True),
                       np.float32)
    kernel_shape = M % 8 == 0 and K % 128 == 0 and N % 128 == 0
    if kernel_shape:
        np.testing.assert_allclose(emu_b, ref_b, rtol=2.0 ** -7,
                                   atol=1e-5 * big)
    else:
        np.testing.assert_allclose(emu_b, ref_b, rtol=0,
                                   atol=2.0 ** -6 * np.abs(ref_b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bias_path_is_the_two_step_add_bit_for_bit(dtype):
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(11)
    x, q, s, b = _inputs(rng, 12, 96, 80, npdt)
    xt, qt, st_, bt = _torch(x), torch.from_numpy(q), torch.from_numpy(s), \
        _torch(b)
    fused = im.int8_linear(xt, qt, st_, bt)
    two = im.int8_matmul(xt, qt, st_) + bt
    assert fused.dtype == xt.dtype
    assert torch.equal(fused.view(torch.int16 if dtype == "bfloat16"
                                  else torch.int32),
                       two.view(torch.int16 if dtype == "bfloat16"
                                else torch.int32))
    assert torch.equal(im._int8_matmul_ref(xt, qt, st_, bt), two)
    # weight_only_linear hands its bias to the same path
    assert torch.equal(weight_only_linear(xt, qt, bt, st_), fused)


def test_gradients_of_x_and_bias_match_jax_grad():
    rng = np.random.default_rng(12)
    x, q, s, b = _inputs(rng, 2 * 8, 128, 256)
    x3 = x.reshape(2, 8, 256)
    jq_, js = jnp.asarray(q), jnp.asarray(s)

    def ref(xv, bv):   # the reference's weight_only_linear: product + bias
        return jnp.sum(jnp.tanh(
            jax_int8_matmul(xv, jq_, js, interpret=True) + bv))

    dx_ref, db_ref = jax.grad(ref, argnums=(0, 1))(jnp.asarray(x3),
                                                   jnp.asarray(b))
    xt = torch.from_numpy(x3).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    st_ = torch.from_numpy(s).requires_grad_()
    torch.tanh(weight_only_linear(xt, torch.from_numpy(q), bt, st_)
               ).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_ref),
                               rtol=1e-5, atol=1e-5)
    assert st_.grad is None
    # the bias alone wanting a gradient records the backward too
    xt2 = torch.from_numpy(x3)
    bt2 = torch.from_numpy(b).requires_grad_()
    torch.tanh(im.int8_linear(xt2, torch.from_numpy(q), st_.detach(), bt2)
               ).sum().backward()
    np.testing.assert_allclose(bt2.grad.numpy(), np.asarray(db_ref),
                               rtol=1e-5, atol=1e-5)


def test_counters_do_not_move_on_the_cpu():
    q = torch.zeros(16, 8, dtype=torch.int8)
    before = (im.int8_matmul.launches, im.int8_matmul.bias_launches)
    im.int8_linear(torch.ones(4, 16), q, torch.ones(8), torch.ones(8))
    assert (im.int8_matmul.launches, im.int8_matmul.bias_launches) == before
    with pytest.raises(ValueError, match="bias"):
        im.int8_linear(torch.ones(4, 16), q, torch.ones(8), torch.ones(7))
