"""The pre-caches of the port's ``blha_attention`` (``pre_key_cache`` /
``pre_value_cache``) against the JAX ``blha_attention`` on the CPU.

The pre-caches put Lp dense keys in front of every row's paged context:
every query sees the whole prefix, and nothing of it is written to the
pools.  Held here, on one step of a mixed batch (a decode row, a prefill
row, a chunk continuing a prefill, an empty row) with GQA and block size
8: the output, both caches and, under ``cache_quant="dynamic"``, the
refreshed scales, at Lp 1, 4 and 9 (the prefix straddles a block's worth
of keys), under cache quantization "none", "static" and "dynamic", with
neox and interleaved rope; the plain versions of K4 and K4-int8 against
the attention the JAX function computes (handed the caches it left); the
plans' context with the prefix; the wrappers' checks of the pre-caches.

Tolerances, float32: the attention output rtol = atol = 2e-4, the
reference's own ``test_pre_cache`` (a step reads its own keys at full
precision and the cached codes it was given, so a code that the two
packages round one apart in this step's write is not read); the float
caches hold the rotated keys (1e-6); a uint8 code may land one apart when
a value sits within ~1e-7 of a rounding boundary (at least 99.9% equal,
none more than 1 apart); the dynamic scales are one float32 division of
the same absmax (rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.paged_attention import blha_attention as jax_blha
from paddle_tpu_torch.ops.hopper.paged_attention import (
    _int8_plan,
    _plan,
    _pre_args,
    paged_attention,
    paged_attention_int8,
    paged_int8_plan,
    paged_plan,
)
from paddle_tpu_torch.ops.paged_attention import blha_attention

torch.set_num_threads(2)

NAMES = ("qkv", "kc", "vc", "enc", "dec", "now", "cu", "bt")
SCALES = ("cache_k_quant_scales", "cache_v_quant_scales",
          "cache_k_dequant_scales", "cache_v_dequant_scales")
TOL = dict(rtol=2e-4, atol=2e-4)
# (query heads, KV heads, head_dim) by prefix length
GEOMETRY = {1: (4, 2, 32), 4: (2, 1, 64), 9: (4, 1, 32)}


def _rope_emb(D, smax):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    fr = np.outer(np.arange(smax), inv)
    return np.stack([np.cos(fr), np.sin(fr)])[:, None, :, None, :].astype(
        np.float32)


def _batch(rng, H, KV, D, Lp, quant):
    """A decode row (13 cached), a prefill row of 6, a chunk of 3 after 10
    cached, an empty row; 3 blocks of 8 a row, not the identity; float
    caches or uint8 codes with per-row scales; the pre-caches [B, KV, Lp,
    D]."""
    bs, P = 8, 3
    now = np.array([1, 6, 3, 0], np.int32)
    dec = np.array([13, 0, 10, 0], np.int32)
    enc = np.array([0, 6, 3, 0], np.int32)
    B = len(now)
    NB = B * P + 2
    bt = rng.permutation(NB)[:B * P].reshape(B, P).astype(np.int32)
    bt[3] = -1                  # the empty row owns no blocks
    T = 12                      # 10 real tokens + 2 of padding
    m = dict(qkv=rng.uniform(-1, 1, (T, (H + 2 * KV) * D)).astype(np.float32),
             enc=enc, dec=dec, now=now, bt=bt,
             cu=np.concatenate([[0], np.cumsum(now)]).astype(np.int32),
             pk=rng.uniform(-1, 1, (B, KV, Lp, D)).astype(np.float32),
             pv=rng.uniform(-1, 1, (B, KV, Lp, D)).astype(np.float32))
    if quant == "none":
        m["kc"] = rng.uniform(-1, 1, (NB, KV, bs, D)).astype(np.float32)
        m["vc"] = rng.uniform(-1, 1, (NB, KV, bs, D)).astype(np.float32)
        return m
    m["kc"] = rng.integers(0, 256, (NB, KV, bs, D)).astype(np.uint8)
    m["vc"] = rng.integers(0, 256, (NB, KV, bs, D)).astype(np.uint8)
    shape = (KV,) if quant == "static" else (B, KV)
    for kind in ("k", "v"):
        qs = rng.uniform(100, 140, shape).astype(np.float32)
        m[f"cache_{kind}_quant_scales"] = qs
        m[f"cache_{kind}_dequant_scales"] = (1 / qs).astype(np.float32)
    return m


def _jax(m, **kw):
    """The JAX blha_attention -> numpy (out, kc, vc, kq, vq, kd, vd)."""
    sc = {n: jnp.asarray(m[n]) for n in SCALES if n in m}
    res = jax_blha(*(jnp.asarray(m[n]) for n in NAMES), **sc,
                   pre_key_cache=jnp.asarray(m["pk"]),
                   pre_value_cache=jnp.asarray(m["pv"]), **kw)
    return [None if r is None else np.asarray(r) for r in res]


def _port(m, **kw):
    """The port's blha_attention on copies of ``m``'s arrays, the caches one
    (drop) block longer -> numpy (out, kc, vc) and the scale tensors,
    updated in place."""
    args = [torch.as_tensor(np.array(m[n])) for n in NAMES]
    for i in (1, 2):
        args[i] = torch.cat([args[i], torch.zeros_like(args[i][:1])])
    sc = {n: torch.as_tensor(np.array(m[n])) for n in SCALES if n in m}
    out, kc, vc = blha_attention(
        *args, **sc, pre_key_cache=torch.as_tensor(m["pk"]),
        pre_value_cache=torch.as_tensor(m["pv"]), **kw)
    assert kc is args[1] and vc is args[2]
    return out.numpy(), kc[:-1].numpy(), vc[:-1].numpy(), sc


def _codes_close(ours, ref):
    assert ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("quant", ["none", "static", "dynamic"])
@pytest.mark.parametrize("Lp", [1, 4, 9])
def test_blha_attention_with_pre_caches_matches_jax(Lp, quant, neox):
    """One step over the pre-caches: output, caches (nothing written for the
    prefix: both pools are the reference's) and the dynamic scales."""
    H, KV, D = GEOMETRY[Lp]
    rng = np.random.default_rng(100 * Lp + len(quant) + neox)
    m = _batch(rng, H, KV, D, Lp, quant)
    kw = dict(num_heads=H, kv_num_heads=KV, head_dim=D, block_size=8,
              max_q_len=6, use_neox_style=neox, cache_quant=quant)
    j = _jax(m, rope_emb=jnp.asarray(_rope_emb(D, 64)), **kw)
    out, kc, vc, sc = _port(m, rope_emb=torch.as_tensor(_rope_emb(D, 64)),
                            **kw)
    np.testing.assert_allclose(out, j[0], **TOL)
    assert not out[int(m["cu"][-1]):].any()     # padding tokens give zeros
    if quant == "none":
        np.testing.assert_allclose(kc, j[1], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(vc, j[2], rtol=1e-6, atol=1e-6)
    else:
        _codes_close(kc, j[1])
        _codes_close(vc, j[2])
    for i, n in enumerate(SCALES):
        if quant == "dynamic":      # the prefill rows' scales refreshed
            np.testing.assert_allclose(sc[n].numpy(), j[3 + i], rtol=1e-6)
            assert not np.array_equal(sc[n].numpy(), m[n])
        elif quant == "static":     # passed through
            np.testing.assert_array_equal(sc[n].numpy(), m[n])


@pytest.mark.parametrize("kernel", ["k4", "k4_int8"])
@pytest.mark.parametrize("Lp", [1, 4, 9])
def test_plain_versions_with_pre_caches_match_jax_core(Lp, kernel):
    """The plain versions of K4 (``paged_attention``) and K4-int8
    (``paged_attention_int8``, static scales) with the pre-caches against
    the attention the JAX blha_attention computes (no rope): each is
    handed the caches the JAX call left, the unrotated q and, for
    K4-int8, this step's k and v."""
    H, KV, D = GEOMETRY[Lp]
    quant = "none" if kernel == "k4" else "static"
    rng = np.random.default_rng(7 * Lp + len(kernel))
    m = _batch(rng, H, KV, D, Lp, quant)
    j = _jax(m, num_heads=H, kv_num_heads=KV, head_dim=D, block_size=8,
             max_q_len=6, use_neox_style=True, cache_quant=quant)
    T = m["qkv"].shape[0]
    qkv = torch.as_tensor(m["qkv"])
    q = qkv[:, :H * D].reshape(T, H, D)
    ints = [torch.as_tensor(m[n]) for n in ("dec", "now", "cu", "bt")]
    pre = dict(pre_key=torch.as_tensor(m["pk"]),
               pre_value=torch.as_tensor(m["pv"]))
    caches = [torch.as_tensor(np.array(c)) for c in j[1:3]]
    if kernel == "k4":
        ours = paged_attention(q, *caches, *ints, 6, **pre)
    else:
        k = qkv[:, H * D:(H + KV) * D].reshape(T, KV, D)
        v = qkv[:, (H + KV) * D:].reshape(T, KV, D)
        scales = [torch.as_tensor(m[n]) for n in SCALES[2:]]
        ours = paged_attention_int8(q, k, v, *caches, *scales, *ints, 6,
                                    **pre)
    np.testing.assert_allclose(ours.numpy(), j[0].reshape(T, H, D), **TOL)


def test_pre_caches_come_together_and_masks_raise():
    """One pre-cache without the other is a ValueError; the masks are still
    A4b's second half."""
    rng = np.random.default_rng(3)
    m = _batch(rng, 4, 2, 32, 4, "none")
    args = [torch.as_tensor(np.array(m[n])) for n in NAMES]
    kw = dict(num_heads=4, kv_num_heads=2, head_dim=32, block_size=8,
              max_q_len=6)
    pk = torch.as_tensor(m["pk"])
    for one in (dict(pre_key_cache=pk), dict(pre_value_cache=pk)):
        with pytest.raises(ValueError, match="together"):
            blha_attention(*args, **one, **kw)
    with pytest.raises(NotImplementedError, match="A4b"):
        blha_attention(*args, pre_key_cache=pk, pre_value_cache=pk,
                       mask=torch.zeros(4, 1, 6, 28), **kw)


def test_pre_args_check_the_pre_caches():
    """What a kernel launch takes of the pre-caches (the CUDA wrappers'
    check, host-side): none, or both [B, KV, Lp, D] of q's dtype,
    contiguous and 16-byte aligned."""
    q = torch.zeros(5, 4, 32)
    ok = torch.zeros(3, 2, 7, 32)
    assert _pre_args("k4", q, None, None, 3, 2) == (0, 0, 0)
    pk, pv, Lp = _pre_args("k4", q, ok, ok.clone(), 3, 2)
    assert Lp == 7 and pk == ok.data_ptr()
    bad = (torch.zeros(3, 2, 7, 16), torch.zeros(2, 2, 7, 32),
           torch.zeros(3, 1, 7, 32), ok.to(torch.bfloat16),
           ok.transpose(2, 3).contiguous().transpose(2, 3),
           torch.zeros(3 * 2 * 7 * 32 + 1)[1:].view(3, 2, 7, 32), None)
    for t in bad:
        with pytest.raises(ValueError, match="pre_key"):
            _pre_args("k4", q, ok, t, 3, 2)
    with pytest.raises(ValueError, match="pre_key"):
        _pre_args("k4", q, ok, torch.zeros(3, 2, 6, 32), 3, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Lp", [1, 64, 130])
def test_plans_split_the_context_with_the_prefix(Lp, dtype):
    """The plans count the prefix in the context they split: the splits'
    chunks cover Lp + P * bs keys and none is left without keys; the
    block fits; at Lp 0 the plan is the one without pre-caches."""
    for T, mq in ((8, 1), (255, 256)):
        for H, KV, D in ((32, 32, 128), (32, 8, 128), (8, 2, 640)):
            B, P, bs = 8, 32, 16
            ctx = P * bs + Lp
            p = paged_plan(T, B, mq, P, bs, H, KV, D, dtype, pre_len=Lp)
            assert p.chunk * p.splits >= ctx > p.chunk * (p.splits - 1)
            assert p.chunk % p.kt == 0 and p.smem <= 232448
            assert paged_plan(T, B, mq, P, bs, H, KV, D, dtype) == _plan(
                T, B, mq, P, bs, H, KV, D, dtype, pre_len=0)
            if D > 512:
                continue
            p8 = paged_int8_plan(T, B, mq, P, bs, H, KV, D, dtype,
                                 pre_len=Lp)
            assert p8.chunk * p8.splits >= ctx > p8.chunk * (p8.splits - 1)
            assert p8.smem <= 232448
            for splits in (1, 2, 4):
                f = _int8_plan(T, B, mq, P, bs, H, KV, D, dtype, False,
                               splits, Lp)
                assert f.chunk * f.splits >= ctx > f.chunk * (f.splits - 1)
    with pytest.raises(ValueError, match="prefix"):
        paged_plan(8, 8, 1, 32, 16, 32, 32, 128, dtype, pre_len=-1)
