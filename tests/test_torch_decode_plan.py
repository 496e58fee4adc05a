"""Kernel B2's division of work and the edges it adds, on the CPU.

``decode_plan`` (``paddle_tpu_torch/ops/hopper/decode_attention.py``)
picks B2's cluster split from host-known sizes (never pos); these tests
hold its choices at the generation path's shapes, its grid (the cluster
divides it) and its shared memory within the 227 KB a block may use for
every head group and head_dim the wrapper takes.  A pure-Python mirror
of the kernel's device-side split (``block_keys`` in
``csrc/decode_attention.cu``) shows that the splits' shares cover keys
0 .. pos exactly once for every pos.  Then the plain
version of B2, which the kernel is held to on the card, against the JAX
Pallas kernel in ``interpret=True`` at the edges the tiles and splits add:
pos 0, 15, 16 and L - 1, a ring of 100 rows, groups of 1, 4, 8 and 16
heads and head_dim 64, 128 and 256.

Tolerance: float32 rtol 1e-5 / atol 1e-5 (one softmax over at most 100
keys, summed in another order), as in test_torch_decode_attention.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas.decode_attention import decode_attention as jdec
from paddle_tpu_torch.ops.hopper import decode_attention as da

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
BF = torch.bfloat16


def split_ranges(pos, L, kt, splits):
    """The kernel's block_keys for every split: pos clamped to [0, L - 1],
    chunk = ceil(ceil((pos + 1) / splits) / kt) kt, split s takes keys
    [s chunk, (s + 1) chunk) cut at pos + 1."""
    n = max(0, min(pos, L - 1)) + 1
    chunk = -(-(-(-n // splits)) // kt) * kt
    out = []
    for s in range(splits):
        c0 = min(s * chunk, n)
        out.append((c0, min(c0 + chunk, n)))
    return out


def test_plan_at_the_generation_shapes():
    """Llama-2-7B heads (32 / 32, D 128) in bfloat16: greedy_decode's 8
    rows over a 512-row ring give 256 blocks, every SM one, and do not
    split; nor does an 8-row 4096-key ring.  The same batch with 32 / 8
    heads (64 blocks) splits in 2, as far as 4 key tiles a split allow on
    a 512-row ring; one row of 32 / 8 heads over 4096 keys (8 blocks)
    splits in 8.  float32 runs the SIMT instance on 32-key tiles."""
    p = da.decode_plan(8, 512, 32, 32, 128, BF)
    assert (p.tc, p.rows, p.kt, p.splits, p.blocks) == (True, 1, 64, 1, 256)
    assert da.decode_plan(8, 4096, 32, 32, 128, BF).splits == 1
    gqa = da.decode_plan(8, 512, 32, 8, 128, BF)
    assert (gqa.rows, gqa.splits, gqa.blocks) == (4, 2, 128)
    one = da.decode_plan(1, 4096, 32, 8, 128, BF)
    assert (one.splits, one.blocks) == (8, 64)
    f32 = da.decode_plan(8, 512, 32, 32, 128, torch.float32)
    assert (f32.tc, f32.kt, f32.splits) == (False, 32, 1)
    # a group past 16 heads takes several blocks (here 4 of 16 heads)
    big = da.decode_plan(8, 512, 64, 1, 128, BF)
    assert big.rows == 16 and big.blocks == 8 * 4 * big.splits


@pytest.mark.parametrize("B,L,H,KVH", [
    (8, 512, 32, 32), (8, 512, 32, 8), (1, 4096, 32, 8), (1, 512, 32, 32),
    (2, 100, 8, 2), (4, 64, 64, 1), (16, 2048, 32, 8), (1, 16, 4, 4)])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_splits_fill_the_card_and_divide_the_grid(B, L, H, KVH, dtype):
    """splits is 1, 2, 4 or 8 (a portable cluster) and is the x extent of
    the grid, so the cluster divides it; 1 where the unsplit grid gives
    the 132 SMs a block each; each split keeps at least MIN_SPLIT_TILES key
    tiles of the ring, and no more splits than the ring has tiles."""
    p = da.decode_plan(B, L, H, KVH, 128, dtype)
    base = B * KVH * -(-(H // KVH) // da.ROWS)
    assert p.splits in (1, 2, 4, 8) and p.blocks == base * p.splits
    if base >= da.SMS:
        assert p.splits == 1
    if p.splits > 1:
        assert base * p.splits // 2 < da.SMS
        assert L >= p.splits * da.MIN_SPLIT_TILES * p.kt
    assert (p.splits - 1) * p.kt < L


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_shared_memory_fits_every_shape_the_wrapper_takes(dtype):
    """For every head_dim the wrapper takes (multiples of 16 up to 256) and
    groups of 1 to 64 heads, the plan's block fits 227 KB, and so does
    every forced split count (the leader's merge grows with it)."""
    for G in (1, 2, 3, 4, 8, 16, 24, 64):
        for D in range(16, 257, 16):
            p = da.decode_plan(4, 2048, 2 * G, 2, D, dtype)
            assert p.smem <= da.SMEM_PER_BLOCK
            assert p.tc == (dtype == BF) and p.kt == da.KEY_TILE[p.tc]
            for splits in (1, 2, 4, 8):
                f = da._plan(4, 2048, 2 * G, 2, D, dtype, splits=splits)
                assert f.splits == splits and f.smem <= da.SMEM_PER_BLOCK


def test_forced_plans_are_private_and_checked():
    """decode_plan takes no overrides; the private _plan refuses what the
    kernel has no instance for (past 512 columns the wide instance takes
    one split only: every head dim has an instance)."""
    import inspect

    assert list(inspect.signature(da.decode_plan).parameters) == [
        "B", "L", "H", "KVH", "D", "dtype"]
    for bad in (dict(splits=3), dict(splits=16), dict(D=0), dict(D=520, splits=2),
                dict(KVH=3), dict(dtype=torch.float16)):
        kw = dict(B=1, L=512, H=8, KVH=2, D=128, dtype=BF)
        kw.update(bad)
        with pytest.raises(ValueError):
            da._plan(**kw)
    # more splits than the ring has key tiles
    with pytest.raises(ValueError):
        da._plan(1, 100, 8, 2, 128, BF, splits=4)


@pytest.mark.parametrize("L,kt", [(100, 64), (512, 64), (512, 128),
                                  (64, 32), (300, 32)])
def test_device_split_covers_every_visible_key_once(L, kt):
    """For every pos (and past the ring, clamped) and every split count the
    ring allows: the shares are contiguous in split order, start on a key
    tile, and cover keys 0 .. min(pos, L - 1) exactly once; a share past
    the keys is empty (that split merges with weight 0)."""
    for splits in (1, 2, 4, 8):
        if (splits - 1) * kt >= L:
            continue
        for pos in list(range(L)) + [L, L + 7]:
            shares = split_ranges(pos, L, kt, splits)
            n = min(pos, L - 1) + 1
            assert shares[0][0] == 0 and shares[-1][1] == n
            for (a0, a1), (b0, b1) in zip(shares, shares[1:]):
                assert a1 == b0
            for c0, c1 in shares:
                assert c0 <= c1 and (c0 % kt == 0 or c0 == n)
            assert sum(c1 - c0 for c0, c1 in shares) == n


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check_plain(B, L, H, KVH, D, pos, seed):
    rng = np.random.default_rng(seed)
    q, kb, vb = _np(rng, B, 1, H, D), _np(rng, B, L, KVH, D), _np(rng, B, L,
                                                                  KVH, D)
    ref = jdec(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
               jnp.int32(pos), block_l=16, interpret=True)
    ours = da.decode_attention(torch.as_tensor(q), torch.as_tensor(kb),
                               torch.as_tensor(vb),
                               torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("pos", [0, 15, 16, 63])
def test_b2_plain_at_the_tile_edges(pos):
    """pos 0 (one key), one short of, at and past a 16-key block, and
    L - 1 of a 64-row ring; 8 / 2 heads."""
    _check_plain(2, 64, 8, 2, 64, pos, seed=pos)


@pytest.mark.parametrize("pos", [0, 63, 64, 99])
def test_b2_plain_on_a_ring_of_100_rows(pos):
    """L not a multiple of any key tile: the reference takes the ring as
    one tile."""
    _check_plain(2, 100, 4, 2, 32, pos, seed=100 + pos)


@pytest.mark.parametrize("G", [1, 4, 8, 16])
def test_b2_plain_at_the_head_groups(G):
    """Groups of 1 (MHA) to 16 heads (one m16 tile of the kernel) over one
    KV head."""
    _check_plain(2, 48, G, 1, 32, 40, seed=G)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_b2_plain_at_the_head_dims(D):
    _check_plain(1, 32, 4, 2, D, 20, seed=D)
