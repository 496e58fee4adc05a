"""The port's public ``incubate.nn.functional.block_multihead_attention``
and ``blha_get_max_len`` against the reference's (``paddle_tpu.incubate.
nn.functional``) on the CPU, on the matrix of tests/test_paged_attention.py:
prefill then decode under ``tgt_mask`` (the prefill under a
causal-plus-padding ``mask``), GQA, a mixed call, interleaved rope, a
pre-cache, ``qkv_bias`` with int32 dequant, static and dynamic cache
quantization (the scales refreshed in place), ``blha_get_max_len``, the
power-of-two bucketing of the padded query length, the typed refusals,
and tokens the reference drops (a block-table entry of -1 or past the
pool, padding past ``cu_seqlens_q[-1]``), which write nothing.

The caches are the reference's public ``[NB, KV, bs, D]`` pools (no drop
block) and are written in place: the same tensors, the same
``data_ptr()``, the reference's values.  Tolerances, float32: outputs rtol
= atol = 2e-5 (sums in another order; 5e-5 for the int32 dequant, whose
values reach ~2e2); float caches 1e-6 where rope rotated the keys or the
int32 dequant's multiply-add wrote them (one rounding or two), byte for
byte elsewhere; uint8 codes at least 99.9% equal, none more
than 1 apart (a value within ~1e-7 of a rounding boundary); dynamic scales
rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.incubate.nn.functional import block_multihead_attention as \
    ref_blha
from paddle_tpu.incubate.nn.functional import blha_get_max_len as \
    ref_max_len
from paddle_tpu_torch.incubate.nn import functional as F
from paddle_tpu_torch.incubate.nn.functional import (
    block_multihead_attention,
    blha_get_max_len,
)

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
H, D, BS = 4, 32, 8
SCALES = ("cache_k_quant_scales", "cache_v_quant_scales",
          "cache_k_dequant_scales", "cache_v_dequant_scales")


def _cu(now):
    return np.concatenate([[0], np.cumsum(now)]).astype(np.int32)


def _run(qkv, kc, vc, enc, dec, now, bt, cu=None, **kw):
    """The reference's and the port's wrapper on the same numpy inputs ->
    (ref out, ref kc, ref vc, port out, port kc, port vc, the port's
    tensors for the scales given as arrays).  Checks that the port wrote
    its caches in place (the same tensors and data_ptr())."""
    enc, dec, now = (np.asarray(x, np.int32) for x in (enc, dec, now))
    cu = _cu(now) if cu is None else cu
    ints = (enc, dec, now)
    ref_kw = {k: (P.to_tensor(v) if isinstance(v, np.ndarray) else v)
              for k, v in kw.items()}
    r = ref_blha(P.to_tensor(qkv), P.to_tensor(kc), P.to_tensor(vc),
                 *(P.to_tensor(x) for x in ints), None, None,
                 P.to_tensor(cu), P.to_tensor(cu), P.to_tensor(bt),
                 block_size=BS, **ref_kw)
    port_kw = {k: (torch.as_tensor(np.array(v)) if isinstance(v, np.ndarray)
                   else v) for k, v in kw.items()}
    tk, tv = torch.as_tensor(np.array(kc)), torch.as_tensor(np.array(vc))
    ptrs = (tk.data_ptr(), tv.data_ptr())
    qkv_t = torch.as_tensor(qkv)
    out, q_back, k_back, v_back = block_multihead_attention(
        qkv_t, tk, tv, *(torch.as_tensor(x) for x in ints), None, None,
        torch.as_tensor(cu), torch.as_tensor(cu), torch.as_tensor(bt),
        block_size=BS, **port_kw)
    assert q_back is qkv_t and k_back is tk and v_back is tv
    assert (tk.data_ptr(), tv.data_ptr()) == ptrs
    return (np.asarray(r[0].numpy()), np.asarray(r[2].numpy()),
            np.asarray(r[3].numpy()), out.numpy(), tk.numpy(), tv.numpy(),
            port_kw)


def _rand(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _blocks(B, per):
    """Sequential free-list allocation, as the reference's test."""
    return np.arange(B * per, dtype=np.int32).reshape(B, per), B * per


def _causal_padding_mask(lens, sq, lk):
    """[B, 1, sq, lk]: 0 where key j <= query s < the row's length, -1e4
    elsewhere (the causal-plus-padding mask of a prefill)."""
    s = np.arange(sq)[:, None]
    j = np.arange(lk)[None, :]
    m = [np.where((j <= s) & (s < n), 0.0, -1e4) for n in lens]
    return np.stack(m)[:, None].astype(np.float32)


def _codes_close(ours, ref):
    assert ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("KV", [H, 2])
def test_prefill_then_decode_under_masks(KV):
    """A prefill of 16 and 11 tokens under a causal-plus-padding ``mask``,
    then a decode step under a random ``tgt_mask`` over the caches the
    prefill left; MHA and GQA 4 / 2."""
    rng = np.random.default_rng(1 + KV)
    B, S = 2, 16
    bt, nb = _blocks(B, 3)
    kc = np.zeros((nb, KV, BS, D), np.float32)
    vc = np.zeros_like(kc)
    lens = [16, 11]
    qkv = _rand(rng, sum(lens), (H + 2 * KV) * D)
    mask = _causal_padding_mask(lens, S, 24)
    ro, rk, rv, po, pk, pv, _ = _run(qkv, kc, vc, lens, [0, 0], lens, bt,
                                     mask=mask)
    np.testing.assert_allclose(po, ro, **TOL)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pv, rv)
    qkv1 = _rand(rng, B, (H + 2 * KV) * D)
    tgt = _rand(rng, B, H, 1, S + 1)
    ro, rk2, rv2, po, pk2, pv2, _ = _run(qkv1, rk, rv, [0, 0], lens, [1, 1],
                                         bt, tgt_mask=tgt)
    np.testing.assert_allclose(po, ro, **TOL)
    np.testing.assert_array_equal(pk2, rk2)
    np.testing.assert_array_equal(pv2, rv2)


def test_mixed_prefill_and_decode_one_call():
    """Row 0 decodes at context 16 while row 1 prefills 6 tokens."""
    rng = np.random.default_rng(3)
    bt, nb = _blocks(2, 3)
    kc, vc = _rand(rng, nb, H, BS, D), _rand(rng, nb, H, BS, D)
    qkv = _rand(rng, 7, 3 * H * D)
    ro, rk, rv, po, pk, pv, _ = _run(qkv, kc, vc, [0, 6], [16, 0], [1, 6],
                                     bt)
    np.testing.assert_allclose(po, ro, **TOL)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pv, rv)


@pytest.mark.parametrize("neox", [False, True])
def test_rope(neox):
    """In-kernel rope at absolute positions ([2, B, Smax, 1, D/2]),
    interleaved (the reference's default) and neox, on a prefill after 5
    cached tokens."""
    rng = np.random.default_rng(4 + neox)
    bt, nb = _blocks(2, 3)
    kc, vc = _rand(rng, nb, H, BS, D), _rand(rng, nb, H, BS, D)
    pos = np.arange(32)
    inv = 10000.0 ** (-np.arange(0, D, 2) / D)
    fr = np.einsum("i,j->ij", pos, inv)
    rope = np.stack([np.cos(fr), np.sin(fr)])[:, None, :, None, :].astype(
        np.float32)
    qkv = _rand(rng, 14, 3 * H * D)
    ro, rk, rv, po, pk, pv, _ = _run(qkv, kc, vc, [7, 7], [5, 5], [7, 7], bt,
                                     rope_emb=rope, use_neox_style=neox)
    np.testing.assert_allclose(po, ro, **TOL)
    np.testing.assert_allclose(pk, rk, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pv, rv)


def test_pre_cache():
    """A 4-key pre-cache in front of every row, under a mask whose key axis
    starts at the prefix."""
    rng = np.random.default_rng(6)
    bt, nb = _blocks(2, 3)
    kc = np.zeros((nb, H, BS, D), np.float32)
    vc = np.zeros_like(kc)
    qkv = _rand(rng, 16, 3 * H * D)
    pre_k, pre_v = _rand(rng, 2, H, 4, D), _rand(rng, 2, H, 4, D)
    mask = _rand(rng, 2, 1, 8, 28)
    ro, rk, rv, po, pk, pv, _ = _run(qkv, kc, vc, [8, 8], [0, 0], [8, 8], bt,
                                     pre_key_cache=pre_k,
                                     pre_value_cache=pre_v, mask=mask)
    np.testing.assert_allclose(po, ro, **TOL)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pv, rv)


def test_qkv_bias_and_int32_dequant():
    """int32 qkv dequantized by qkv_out_scale, then qkv_bias, in float32."""
    rng = np.random.default_rng(7)
    bt, nb = _blocks(2, 3)
    kc = np.zeros((nb, H, BS, D), np.float32)
    vc = np.zeros_like(kc)
    qkv = np.round(_rand(rng, 8, 3 * H * D) / 0.01).astype(np.int32)
    bias = rng.uniform(-0.5, 0.5, 3 * H * D).astype(np.float32)
    scale = np.full(3 * H * D, 0.01, np.float32)
    ro, rk, rv, po, pk, pv, _ = _run(qkv, kc, vc, [4, 4], [0, 0], [4, 4], bt,
                                     qkv_out_scale=scale, qkv_bias=bias,
                                     compute_dtype="fp32")
    np.testing.assert_allclose(po, ro, rtol=5e-5, atol=5e-5)
    # the dequant's multiply-add may round once (fused) or twice: 1 ulp
    np.testing.assert_allclose(pk, rk, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pv, rv, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dynamic", [False, True])
def test_cache_quant(dynamic):
    """uint8 caches: a prefill, then a decode step over the codes it wrote
    (both sides continue from the reference's codes); static scales [KV]
    pass through, dynamic ones [B, KV] are refreshed IN PLACE by the
    prefill (the same tensors: the decode reads them)."""
    rng = np.random.default_rng(8 + dynamic)
    B, S = 2, 16
    bt, nb = _blocks(B, 3)
    kc = np.zeros((nb, H, BS, D), np.uint8)
    vc = np.zeros_like(kc)
    qkv = _rand(rng, B * S, 3 * H * D)
    if dynamic:
        sc = {n: np.zeros((B, H), np.float32) for n in SCALES}
    else:
        kq = rng.uniform(100, 140, H).astype(np.float32)
        vq = rng.uniform(100, 140, H).astype(np.float32)
        sc = dict(zip(SCALES, (kq, vq, 1 / kq, 1 / vq)))
    ref_sc = {n: P.to_tensor(v) for n, v in sc.items()}
    port_sc = {n: torch.as_tensor(np.array(v)) for n, v in sc.items()}
    ptrs = [t.data_ptr() for t in port_sc.values()]
    lens = [S] * B

    def both(qkv, kc, vc, enc, dec, now):
        enc, dec, now = (np.asarray(x, np.int32) for x in (enc, dec, now))
        cu = _cu(now)
        r = ref_blha(P.to_tensor(qkv), P.to_tensor(kc), P.to_tensor(vc),
                     P.to_tensor(enc), P.to_tensor(dec), P.to_tensor(now),
                     None, None, P.to_tensor(cu), P.to_tensor(cu),
                     P.to_tensor(bt), block_size=BS,
                     use_dynamic_cachekv_quant=dynamic, **ref_sc)
        tk, tv = torch.as_tensor(np.array(kc)), torch.as_tensor(np.array(vc))
        out = block_multihead_attention(
            torch.as_tensor(qkv), tk, tv, torch.as_tensor(enc),
            torch.as_tensor(dec), torch.as_tensor(now), None, None,
            torch.as_tensor(cu), torch.as_tensor(cu), torch.as_tensor(bt),
            block_size=BS, use_dynamic_cachekv_quant=dynamic, **port_sc)[0]
        return (np.asarray(r[0].numpy()), np.asarray(r[2].numpy()),
                np.asarray(r[3].numpy()), out.numpy(), tk.numpy(),
                tv.numpy())

    ro, rk, rv, po, pk, pv = both(qkv, kc, vc, lens, [0, 0], lens)
    np.testing.assert_allclose(po, ro, **TOL)
    _codes_close(pk, rk)
    _codes_close(pv, rv)
    for n in SCALES:
        np.testing.assert_allclose(port_sc[n].numpy(),
                                   np.asarray(ref_sc[n].numpy()), rtol=1e-6)
        if dynamic:
            assert (port_sc[n].numpy() > 0).all()   # refreshed in place
    assert [t.data_ptr() for t in port_sc.values()] == ptrs
    qkv1 = _rand(rng, B, 3 * H * D)
    ro, *_, po, _, _ = both(qkv1, rk, rv, [0, 0], lens, [1, 1])
    np.testing.assert_allclose(po, ro, **TOL)


def test_blha_get_max_len():
    """The maxima over the first batch_size rows, int32 [1] each."""
    enc = np.array([3, 9, 0, 50], np.int32)
    dec = np.array([5, 0, 2, 70], np.int32)
    for b in (3, np.array([3]), 1, 4):
        me, md = blha_get_max_len(torch.as_tensor(enc), torch.as_tensor(dec),
                                  torch.as_tensor(b))
        re, rd = ref_max_len(P.to_tensor(enc), P.to_tensor(dec),
                             P.to_tensor(np.array(b).reshape(-1)))
        assert me.dtype == md.dtype == torch.int32
        assert tuple(me.shape) == tuple(md.shape) == (1,)
        assert int(me[0]) == int(np.asarray(re.numpy())[0])
        assert int(md[0]) == int(np.asarray(rd.numpy())[0])


@pytest.mark.parametrize("now,bucket", [([5, 3], 8), ([1, 1], 1),
                                        ([16, 0], 16), ([0, 0], 1),
                                        ([17, 2], 32)])
def test_max_q_len_is_bucketed_to_a_power_of_two(monkeypatch, now, bucket):
    """The padded query length the wrapper hands blha_attention is
    max(seq_lens_this_time) rounded up to a power of two (1 at most 1), and
    the output is the reference's."""
    seen = []
    real = F.blha_attention

    def spy(*args, **kw):
        seen.append(kw["max_q_len"])
        return real(*args, **kw)

    monkeypatch.setattr(F, "blha_attention", spy)
    rng = np.random.default_rng(sum(now))
    bt, nb = _blocks(2, 5)
    kc, vc = _rand(rng, nb, H, BS, D), _rand(rng, nb, H, BS, D)
    qkv = _rand(rng, max(sum(now), 1), 3 * H * D)
    ro, rk, rv, po, pk, pv, _ = _run(qkv, kc, vc, [0, 0], [3, 0], now, bt)
    assert seen == [bucket]
    np.testing.assert_allclose(po, ro, **TOL)
    np.testing.assert_array_equal(pk, rk)


def test_dropped_tokens_write_nothing():
    """Tokens the reference drops write nothing into the pools, which have
    no drop block: a row whose block-table entry for its position is -1,
    one whose entry is past the pool (>= NB), and padding tokens past
    cu_seqlens_q[-1].  The pools equal the reference's byte for byte, in
    place; the blocks nobody names keep their bytes."""
    rng = np.random.default_rng(10)
    B = 4
    bt = np.array([[0, -1, 2], [3, 4, 5], [6, 99, 8], [9, 10, 11]], np.int32)
    nb = 13
    kc, vc = _rand(rng, nb, H, BS, D), _rand(rng, nb, H, BS, D)
    now = np.array([2, 3, 2, 1], np.int32)
    # row 0 writes positions 8-9 (block -1), row 2 positions 9-10 (block
    # 99 >= NB), row 1 and 3 write in the pool; 3 padding tokens
    dec = np.array([8, 0, 9, 5], np.int32)
    enc = np.array([0, 3, 0, 0], np.int32)
    qkv = _rand(rng, int(now.sum()) + 3, 3 * H * D)
    ro, rk, rv, po, pk, pv, _ = _run(qkv, kc, vc, enc, dec, now, bt)
    assert pk.tobytes() == rk.tobytes() and pv.tobytes() == rv.tobytes()
    np.testing.assert_allclose(po, ro, **TOL)
    # only row 1's first block (3) and row 3's (9) were written
    changed = {int(b) for b in np.nonzero(
        (pk != kc).reshape(nb, -1).any(axis=1))[0]}
    assert changed == {3, 9}


def test_refusals(monkeypatch):
    """block_size against the caches' block axis, int32 qkv without a
    compute_dtype, dynamic scales that are not tensors (they are refreshed
    in place), and a call inside a CUDA graph's capture (the host read of
    max(seq_lens_this_time) needs an eager call)."""
    bt, nb = _blocks(1, 2)
    kc = torch.zeros(nb, H, BS, D)
    vc = torch.zeros_like(kc)
    ints = [torch.tensor([1], dtype=torch.int32) for _ in range(3)]
    cu = torch.tensor([0, 1], dtype=torch.int32)
    args = (kc, vc, *ints, None, None, cu, cu, torch.as_tensor(bt))
    qkv = torch.zeros(1, 3 * H * D)
    with pytest.raises(ValueError, match="block_size"):
        block_multihead_attention(qkv, *args, block_size=16)
    with pytest.raises(ValueError, match="compute_dtype"):
        block_multihead_attention(qkv.int(), *args, block_size=BS)
    sc = {n: np.ones((1, H), np.float32) for n in SCALES}
    with pytest.raises(TypeError, match="IN PLACE"):
        block_multihead_attention(qkv, kc.byte(), vc.byte(), *args[2:],
                                  block_size=BS,
                                  use_dynamic_cachekv_quant=True, **sc)
    monkeypatch.setattr(F, "_capturing", lambda: True)
    with pytest.raises(ValueError, match="eagerly|ServingEngine"):
        block_multihead_attention(qkv, *args, block_size=BS)


def test_the_wrapper_imports_neither_jax_nor_paddle_tpu():
    """The public wrapper's module is the port's own copy: importing it
    loads no module of JAX or of paddle_tpu."""
    import os
    import subprocess
    import sys

    code = ("import sys, paddle_tpu_torch.incubate.nn.functional\n"
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu')"
            " or m.startswith(('jax.', 'paddle_tpu.'))]\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
