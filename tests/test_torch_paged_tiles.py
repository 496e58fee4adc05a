"""Kernel K4's division of work and the edges it adds, on the CPU.

``paged_plan`` (``paddle_tpu_torch/ops/hopper/paged_attention.py``) picks
K4's query tile, key tile and cluster split from host-known sizes; these
tests hold its choices at the serving programs' sizes and its shared
memory within the 227 KB a block may use for every head group and head_dim
the wrapper takes.  Then the plain version of K4, which the kernel is held
to on the card, against the attention of the JAX ``blha_attention`` at the
edges the tiles and splits add: visible key counts at 0, 1 and -1 mod the
16-key block and mod the split chunk, a row with ``now = 0``, ``now >
max_q_len``, block ids outside the pool, GQA groups 1, 4 and 8 and head_dim
64, 128 and 256.

Tolerance: float32; the attention output sums over the context in another
order (2e-5 abs / 2e-5 rel), as in test_torch_paged_attention.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.paged_attention import blha_attention as jax_blha
from paddle_tpu_torch.ops.hopper import paged_attention as pa

torch.set_num_threads(2)

BS = 16                     # the serving block size


def p_qt(mq):
    """The query tile of a one-head group (the plan's cap)."""
    return 1 if mq <= 1 else min(mq, pa.MAX_QT)


def _ctx_sizes():
    return dict(P=32, bs=BS)  # max_seq_len 512, as chip_smoke's phase 3


def test_plan_at_the_serving_programs():
    """Llama-2-7B heads (32 / 32, D 128), 8 rows, bfloat16 on the tensor
    cores: decode (mq 1) takes one token a tile and does not split (256
    blocks give every SM one); the mixed loop (mq 16) takes the whole
    16-token chunk as one tile; the single step (mq 256, T 256) has 736
    blocks and does not split.  float32 runs SIMT tiles of 8 query rows in
    a ring of 3."""
    bf = torch.bfloat16
    decode = pa.paged_plan(8, 8, 1, H=32, KV=32, D=128, dtype=bf,
                           **_ctx_sizes())
    assert (decode.qt, decode.kt, decode.stages, decode.splits) == (
        1, 64, 2, 1)
    mixed = pa.paged_plan(256, 8, 16, H=32, KV=32, D=128, dtype=bf,
                          **_ctx_sizes())
    assert mixed.qt == 16 and mixed.blocks == 8 * 32
    single = pa.paged_plan(256, 8, 256, H=32, KV=32, D=128, dtype=bf,
                           **_ctx_sizes())
    # T = 256 tokens in 8 rows fill at most 23 tiles of 16: 736 blocks
    assert single.qt == 16 and single.splits == 1
    assert single.blocks == 23 * 32
    # the GQA decode geometry (8 / 2, D 256): 16 blocks, clusters of 4
    gqa = pa.paged_plan(8, 8, 1, H=8, KV=2, D=256, dtype=bf, **_ctx_sizes())
    assert gqa.qt == 1 and gqa.splits == 4 and gqa.blocks == 64
    # long-context decode, 2 rows of a 4096-key pool: 64 blocks x 4
    long = pa.paged_plan(2, 2, 1, 256, BS, 32, 32, 128, bf)
    assert long.splits == 4 and long.chunk == 1024
    # a larger group takes fewer tokens a tile (about 64 query rows)
    assert pa.paged_plan(256, 8, 16, H=32, KV=4, D=128, dtype=bf,
                         **_ctx_sizes()).qt == 8
    assert pa.paged_plan(40, 8, 5, H=8, KV=8, D=128, dtype=bf,
                         **_ctx_sizes()).qt == 5
    # forced choices (chip_smoke's edge check) replace the rules, within
    # what the kernel takes: a tensor-core ring of 2, at most 4 splits
    forced = pa._plan(256, 8, 16, H=32, KV=32, D=128, dtype=bf,
                      qt=4, splits=4, stages=2, **_ctx_sizes())
    assert (forced.qt, forced.stages, forced.splits, forced.chunk) == (
        4, 2, 4, 128)
    for bad in (dict(stages=3), dict(splits=8)):
        with pytest.raises(ValueError):
            pa._plan(256, 8, 16, H=32, KV=32, D=128, dtype=bf, **bad,
                     **_ctx_sizes())
    # float32: 8-token tiles, a ring of 3 (of 32-key tiles at D 128, to
    # keep the ring within STAGE_BYTES), 2 where 3 does not fit
    f32 = pa.paged_plan(256, 8, 256, H=32, KV=32, D=128,
                        dtype=torch.float32, **_ctx_sizes())
    assert (f32.qt, f32.kt, f32.stages) == (8, 32, 3)
    assert pa.paged_plan(8, 8, 1, H=8, KV=2, D=256, dtype=torch.float32,
                         **_ctx_sizes()).stages == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mq", [1, 16, 256])
def test_plan_shared_memory_and_chunks(dtype, mq):
    """Every head group up to 64 and every head_dim the wrapper takes
    (multiples of 8 up to 256): the block fits 227 KB, or the plan raises
    naming the limit (a bfloat16 tile takes at most 64 query rows); the
    chunks cover the context, are whole key tiles and leave no split
    without keys; a cluster holds at most 4 blocks."""
    for G in list(range(1, 9)) + [16, 32, 64]:
        for D in range(8, 257, 8):
            for P in (1, 32, 256):
                try:
                    p = pa.paged_plan(256, 8, mq, P, BS, 2 * G, 2, D, dtype)
                except ValueError as e:
                    assert "227 KB" in str(e) or (
                        "64 query rows" in str(e) and G * p_qt(mq) > 64)
                    continue
                ctx = P * BS
                assert p.smem <= pa.SMEM_PER_BLOCK, (G, D, p)
                assert p.kt in pa.KEY_TILES and p.chunk % p.kt == 0
                assert p.qt * G <= pa.TC_ROWS or dtype == torch.float32
                assert 1 <= p.splits <= pa.SPLIT_CAP
                assert p.chunk * p.splits >= ctx
                assert p.splits == 1 or p.chunk * (p.splits - 1) < ctx
                assert 1 <= p.qt <= max(mq, 1)
    # the decode groups the port serves all fit
    for G, D in ((1, 128), (4, 128), (8, 128), (64, 128), (4, 256)):
        pa.paged_plan(8, 8, 1, 32, BS, G, 1, D, dtype)
    with pytest.raises(ValueError, match="64 query rows"):
        pa.paged_plan(1, 1, 1, 1, BS, 128, 1, 256, torch.bfloat16)
    with pytest.raises(ValueError, match="227 KB"):
        pa.paged_plan(1, 1, 1, 1, BS, 128, 1, 256, torch.float32)


@pytest.mark.parametrize("T,B,KV,mq", [
    (8, 8, 32, 1), (256, 8, 32, 16), (256, 8, 32, 256), (64, 64, 32, 1),
    (2, 2, 32, 1), (8, 8, 2, 1), (8, 8, 1, 1), (128, 128, 8, 1),
    (256, 16, 8, 16)])
def test_plan_splits_only_an_underfilled_grid(T, B, KV, mq):
    """splits is 1 wherever the plain grid gives each of the 132 SMs a
    block; where it splits, half as many splits would leave SMs without
    one, and it never takes more than SPLIT_CAP.  The grid holds no more
    query tiles than T tokens in B rows can fill."""
    p = pa.paged_plan(T, B, mq, 32, BS, 32, KV, 128, torch.bfloat16)
    base = p.blocks // p.splits
    assert base // KV <= min(B * -(-max(mq, 1) // p.qt),
                             (T + B * (p.qt - 1)) // p.qt)
    assert 1 <= p.splits <= pa.SPLIT_CAP
    if base >= pa.SMS:
        assert p.splits == 1
    else:
        assert p.splits == pa.SPLIT_CAP or base * p.splits >= pa.SMS
        assert p.splits == 1 or base * (p.splits // 2) < pa.SMS


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check(rng, G, D, dec, now, mq, bad=(), P=12, KV=2, pad=3):
    """JAX blha_attention (writes this step's K/V, then attends) against
    the port's plain K4 on the caches it left: [T, H, D] outputs."""
    H = G * KV
    B = len(now)
    dec = np.asarray(dec, np.int32)
    now = np.asarray(now, np.int32)
    cu = np.concatenate([[0], np.cumsum(now)]).astype(np.int32)
    T = int(cu[-1]) + pad
    NB = B * P + 4
    bt = rng.permutation(NB)[:B * P].reshape(B, P).astype(np.int32)
    for (b, j), v in bad:
        bt[b, j] = v
    qkv = _np(rng, T, (H + 2 * KV) * D)
    kc, vc = _np(rng, NB, KV, BS, D), _np(rng, NB, KV, BS, D)
    enc = np.where(dec == 0, now, 0).astype(np.int32)
    out, kc2, vc2, *_ = jax_blha(
        *(jnp.asarray(a) for a in (qkv, kc, vc, enc, dec, now, cu, bt)),
        num_heads=H, kv_num_heads=KV, head_dim=D, block_size=BS,
        max_q_len=mq, use_neox_style=True)
    q = torch.as_tensor(qkv[:, :H * D].reshape(T, H, D))
    ours = pa.paged_attention(
        q, torch.as_tensor(np.array(kc2)), torch.as_tensor(np.array(vc2)),
        *(torch.as_tensor(a) for a in (dec, now, cu, bt)), mq)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(out).reshape(T, H, D),
                               rtol=2e-5, atol=2e-5)
    assert not ours[int(cu[-1]):].any()        # padding tokens give zeros
    return ours, cu


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_plain_matches_jax_at_decode_edges(G, D):
    """Decode rows whose visible key counts sit at 0, 1 and -1 mod 16 and
    mod the split chunk K4 would use for this geometry, a position past the
    pool (clamped to its last key), an empty row (now = 0), and block ids
    -1 and past the pool inside a row's context (read as zeros)."""
    P = 12
    chunk = pa.paged_plan(8, 8, 1, P, BS, 2 * G, 2, D,
                          torch.bfloat16).chunk
    ctx = P * BS
    counts = sorted({1, 15, 16, 17, chunk - 1, chunk, min(chunk + 1, ctx)})
    counts = [n for n in counts if 1 <= n <= ctx][:6]
    dec = [n - 1 for n in counts] + [ctx + 8, 0]
    now = [1] * (len(counts) + 1) + [0]
    rng = np.random.default_rng(100 + G * 7 + D)
    ours, cu = _check(rng, G, D, dec, now, mq=1,
                      bad=[((len(counts) - 1, 0), -1),
                           ((len(counts), 2), 12 * 8 + 50)])
    assert ours[int(cu[-2]):int(cu[-1])].numel() == 0  # the empty row


@pytest.mark.parametrize("mq", [16, 5])
def test_plain_matches_jax_across_query_tiles(mq):
    """Prefill chunks at the query tiles' edges: rows of 16, 17, 15 and 1
    tokens after cached contexts, a row with now > max_q_len (its tokens
    past max_q_len give zeros), an empty row and an out-of-pool block."""
    rng = np.random.default_rng(40 + mq)
    dec = [0, 31, 16, 100, 5, 0, 63]
    now = [16, 17, 15, 1, 20, 0, 9]
    ours, cu = _check(rng, 4, 64, dec, now, mq=mq, bad=[((3, 1), -1)])
    # row 4's tokens at local index >= max_q_len are zeros
    r4 = ours[int(cu[4]):int(cu[5])]
    assert not r4[mq:].any() and r4[:min(mq, 20)].abs().sum() > 0
