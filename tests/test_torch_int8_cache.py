"""The port's int8 paged KV cache against the JAX package on the CPU.

``blha_attention``'s static and dynamic cache quantization (uint8 caches,
scales, the prefill and the decode outputs), the dynamic refresh in
place, an out-of-pool block inside the visible range, the elementwise
surface (interleaved rope, int32 ``qkv_out_scale`` + bias, shift/smooth and
the int8 output quantization) and the helpers; K4-int8's plain version
against the JAX attention core at head dims 72, 128, 264 and 640; and
``ServingEngine(cache_quant="int8", device="cpu")`` against the JAX engine
(greedy and seeded sampled tokens, logprobs, counters) with the
reference's scheduling contract.

Tolerances, all float32: a uint8 cache entry is round(x * scale) of a
value both packages compute with float32 arithmetic in another order, so
an entry within ~1e-7 of a rounding boundary may land one code apart (at
least 99.9% equal, never more than 1 apart); the dynamic scales are one
float32 division of the same absmax (rtol 1e-6); the prefill output reads
only this step's full-precision keys (2e-4, the reference's own bound); the
decode output reads the dequantized caches, where one code is ~1% of a
scale (1e-3); engine logprobs as tests/test_torch_serving.py (rtol 1e-4,
atol 1e-5).  The bfloat16 epilogue test (Queue C9) holds bf16 outputs to
one bf16 step and 99.9% equal: both packages round one float32 value once.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as P
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.paged_attention import blha_attention as jax_blha
from paddle_tpu.ops.paged_attention import (
    build_padding_metadata as jax_padding,
)
from paddle_tpu.ops.paged_attention import rope_rotate as jax_rope
from paddle_tpu_torch.inference.serving import ServingEngine as PortEngine
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.models.llama import load_numpy_state_dict
from paddle_tpu_torch.ops.hopper import fused_ops
from paddle_tpu_torch.ops.hopper.paged_attention import (
    _int8_launch_plan,
    _int8_plan,
    _int8_smem_bytes,
    _paged_attention_int8_ref,
    paged_attention,
    paged_attention_int8,
    paged_int8_plan,
    paged_plan,
)
from paddle_tpu_torch.ops.paged_attention import (
    blha_attention,
    build_padding_metadata,
    rope_rotate,
)

torch.set_num_threads(2)

NAMES = ("qkv", "kc", "vc", "enc", "dec", "now", "cu", "bt")
SCALES = ("cache_k_quant_scales", "cache_v_quant_scales",
          "cache_k_dequant_scales", "cache_v_dequant_scales")


def _rope_emb(D, smax):
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    fr = np.outer(np.arange(smax), inv)
    return np.stack([np.cos(fr), np.sin(fr)])[:, None, :, None, :].astype(
        np.float32)


def _jax(m, **kw):
    """The JAX blha_attention on the arrays of ``m`` -> numpy (out, kc, vc,
    kq, vq, kd, vd)."""
    sc = {n: jnp.asarray(m[n]) for n in SCALES if n in m}
    res = jax_blha(*(jnp.asarray(m[n]) for n in NAMES), **sc, **kw)
    return [None if r is None else np.asarray(r) for r in res]


def _port(m, **kw):
    """The port's blha_attention on copies of the arrays of ``m``, the
    caches one (drop) block longer -> numpy (out, kc, vc) and the scale
    tensors, updated in place."""
    args = [torch.as_tensor(np.array(m[n])) for n in NAMES]
    for i in (1, 2):
        args[i] = torch.cat([args[i], torch.zeros_like(args[i][:1])])
    sc = {n: torch.as_tensor(np.array(m[n])) for n in SCALES if n in m}
    out, kc, vc = blha_attention(*args, **sc, **kw)
    assert kc is args[1] and vc is args[2]
    return out.numpy(), kc[:-1].numpy(), vc[:-1].numpy(), sc


def _codes_close(ours, ref):
    """uint8 caches: at least 99.9% of entries equal, none more than one
    code apart."""
    assert ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def _packed(rng, B, H, KV, S, D):
    qkv = rng.uniform(-1, 1, (B * S, (H + 2 * KV) * D)).astype(np.float32)
    return qkv


@pytest.mark.parametrize("ties_away", [True, False])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_blha_quant_matches_jax(mode, ties_away):
    """The reference's TestCacheQuant shapes (B 2, H 4, S 16, D 32, bs 8)
    with rope: a one-shot prefill, then one decode step over the caches and
    scales each package left."""
    B, H, S, D, bs = 2, 4, 16, 32, 8
    rng = np.random.default_rng(3)
    P_ = (S + 8 + bs - 1) // bs
    bt = rng.permutation(B * P_).astype(np.int32).reshape(B, P_)
    m = dict(qkv=_packed(rng, B, H, H, S, D),
             kc=np.zeros((B * P_, H, bs, D), np.uint8),
             enc=np.full(B, S, np.int32), dec=np.zeros(B, np.int32),
             now=np.full(B, S, np.int32),
             cu=np.arange(0, B * S + 1, S, dtype=np.int32), bt=bt)
    m["vc"] = m["kc"].copy()
    if mode == "dynamic":
        for n in SCALES:
            m[n] = np.zeros((B, H), np.float32)
    else:
        kmax = np.abs(m["qkv"][:, H * D:2 * H * D]).reshape(-1, H, D).max(
            axis=(0, 2)) * 1.2
        vmax = np.abs(m["qkv"][:, 2 * H * D:]).reshape(-1, H, D).max(
            axis=(0, 2))
        m.update(cache_k_quant_scales=(127 / kmax).astype(np.float32),
                 cache_v_quant_scales=(127 / vmax).astype(np.float32),
                 cache_k_dequant_scales=(kmax / 127).astype(np.float32),
                 cache_v_dequant_scales=(vmax / 127).astype(np.float32))
    kw = dict(num_heads=H, kv_num_heads=H, head_dim=D, block_size=bs,
              max_q_len=S, use_neox_style=True, cache_quant=mode,
              round_ties_away=ties_away)
    rope = _rope_emb(D, 64)
    j = _jax(m, rope_emb=jnp.asarray(rope), **kw)
    p_out, p_kc, p_vc, p_sc = _port(m, rope_emb=torch.as_tensor(rope), **kw)
    _codes_close(p_kc, j[1])
    _codes_close(p_vc, j[2])
    for i, n in enumerate(SCALES):
        np.testing.assert_allclose(p_sc[n].numpy(), j[3 + i], rtol=1e-6)
    if mode == "dynamic":
        assert (p_sc["cache_k_dequant_scales"].numpy() > 0).all()
    np.testing.assert_allclose(p_out, j[0], rtol=2e-4, atol=2e-4)
    # one decode token a row over each package's own caches and scales
    d = dict(qkv=_packed(rng, B, H, H, 1, D), enc=np.zeros(B, np.int32),
             dec=np.full(B, S, np.int32), now=np.ones(B, np.int32),
             cu=np.arange(B + 1, dtype=np.int32), bt=bt)
    kw["max_q_len"] = 1
    jd = _jax({**d, "kc": j[1], "vc": j[2],
               **dict(zip(SCALES, j[3:]))},
              rope_emb=jnp.asarray(rope), **kw)
    pd = _port({**d, "kc": p_kc, "vc": p_vc,
                **{n: p_sc[n].numpy() for n in SCALES}},
               rope_emb=torch.as_tensor(rope), **kw)
    np.testing.assert_allclose(pd[0], jd[0], rtol=1e-3, atol=1e-3)
    _codes_close(pd[1], jd[1])


def _mixed(rng, H=4, KV=2, D=32, bs=4, P_=6):
    """A decode row (9 cached), a prefill row of 5, a chunk of 3 after 6
    cached, an empty row; random uint8 caches and positive scales."""
    B = 4
    now = np.array([1, 5, 3, 0], np.int32)
    NB = B * P_ + 2
    bt = rng.permutation(NB)[:B * P_].reshape(B, P_).astype(np.int32)
    bt[3] = -1
    m = dict(qkv=rng.uniform(-1, 1, (12, (H + 2 * KV) * D)).astype(
                 np.float32),
             kc=rng.integers(0, 256, (NB, KV, bs, D)).astype(np.uint8),
             vc=rng.integers(0, 256, (NB, KV, bs, D)).astype(np.uint8),
             enc=np.array([0, 5, 3, 0], np.int32),
             dec=np.array([9, 0, 6, 0], np.int32), now=now,
             cu=np.concatenate([[0], np.cumsum(now)]).astype(np.int32),
             bt=bt)
    for n in SCALES:
        m[n] = rng.uniform(0.5, 2.0, (B, KV)).astype(np.float32)
    for n in SCALES[2:]:
        m[n] /= 127.0
    return m


@pytest.mark.parametrize("oob", [False, True])
def test_blha_dynamic_gqa_mixed_batch(oob):
    """GQA (4 heads over 2) on a mixed prefill + decode batch over random
    caches and scales; with ``oob`` the decode row's first block-table
    entry (its keys 0-3, all visible) is outside the pool, which the
    reference gathers as uint8 0, i.e. -128 * d."""
    rng = np.random.default_rng(21)
    m = _mixed(rng)
    if oob:
        m["bt"][0, 0] = -1
    kw = dict(num_heads=4, kv_num_heads=2, head_dim=32, block_size=4,
              max_q_len=5, use_neox_style=True, cache_quant="dynamic")
    rope = _rope_emb(32, 64)
    j = _jax(m, rope_emb=jnp.asarray(rope), **kw)
    p_out, p_kc, p_vc, p_sc = _port(m, rope_emb=torch.as_tensor(rope), **kw)
    _codes_close(p_kc, j[1])
    _codes_close(p_vc, j[2])
    for i, n in enumerate(SCALES):
        np.testing.assert_allclose(p_sc[n].numpy(), j[3 + i], rtol=1e-6)
    np.testing.assert_allclose(p_out, j[0], rtol=2e-5, atol=2e-5)
    assert not p_out[9:].any()                   # padding tokens: zeros


def test_dynamic_refresh_in_place_only_prefill_rows():
    """The four scale tensors are the caller's, refreshed in place; rows
    with seq_lens_encoder 0 (the decode row, the empty row) keep theirs,
    rows in prefill take absmax / 127 of this step's (rotated) keys."""
    rng = np.random.default_rng(22)
    m = _mixed(rng)
    before = {n: m[n].copy() for n in SCALES}
    args = [torch.as_tensor(np.array(m[n])) for n in NAMES]
    for i in (1, 2):
        args[i] = torch.cat([args[i], torch.zeros_like(args[i][:1])])
    sc = {n: torch.as_tensor(np.array(m[n])) for n in SCALES}
    ptrs = {n: t.data_ptr() for n, t in sc.items()}
    blha_attention(*args, **sc, num_heads=4, kv_num_heads=2, head_dim=32,
                   block_size=4, max_q_len=5, cache_quant="dynamic")
    assert {n: t.data_ptr() for n, t in sc.items()} == ptrs
    for n in SCALES:
        got = sc[n].numpy()
        np.testing.assert_array_equal(got[[0, 3]], before[n][[0, 3]])
        assert not np.array_equal(got[[1, 2]], before[n][[1, 2]])
    k = m["qkv"][:, 4 * 32:6 * 32].reshape(12, 2, 32)      # no rope here
    for b, lo, hi in ((1, 1, 6), (2, 6, 9)):
        absmax = np.abs(k[lo:hi]).max(axis=(0, 2))
        np.testing.assert_allclose(
            sc["cache_k_dequant_scales"].numpy()[b], absmax / 127.0,
            rtol=1e-6)
    # seq_lens_encoder None: no row refreshes
    sc2 = {n: torch.as_tensor(np.array(m[n])) for n in SCALES}
    blha_attention(*args[:3], None, *args[4:], **sc2, num_heads=4,
                   kv_num_heads=2, head_dim=32, block_size=4, max_q_len=5,
                   cache_quant="dynamic")
    for n in SCALES:
        np.testing.assert_array_equal(sc2[n].numpy(), m[n])


def test_interleaved_rope_matches_jax():
    """use_neox_style=False rotates the interleaved pairs (K2's
    ``interleaved`` mode) — blha_attention's output and caches against
    JAX; K2's plain version and the port's rope_rotate against JAX's
    rope_rotate in both styles."""
    rng = np.random.default_rng(23)
    m = _mixed(rng)
    m["kc"] = rng.standard_normal(m["kc"].shape).astype(np.float32)
    m["vc"] = rng.standard_normal(m["vc"].shape).astype(np.float32)
    kw = dict(num_heads=4, kv_num_heads=2, head_dim=32, block_size=4,
              max_q_len=5, use_neox_style=False)
    rope = _rope_emb(32, 64)
    j = _jax({n: m[n] for n in NAMES}, rope_emb=jnp.asarray(rope), **kw)
    p = _port({n: m[n] for n in NAMES}, rope_emb=torch.as_tensor(rope), **kw)
    np.testing.assert_allclose(p[1], j[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p[0], j[0], rtol=2e-5, atol=2e-5)
    x = rng.standard_normal((3, 7, 4, 32)).astype(np.float32)
    y = rng.standard_normal((3, 7, 2, 32)).astype(np.float32)
    cos = rng.standard_normal((7, 16)).astype(np.float32)
    sin = rng.standard_normal((7, 16)).astype(np.float32)
    c4, s4 = cos[None, :, None, :], sin[None, :, None, :]
    for neox in (True, False):
        want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(c4),
                                   jnp.asarray(s4), neox))
        got = rope_rotate(torch.as_tensor(x), torch.as_tensor(c4),
                          torch.as_tensor(s4), neox).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        oq, ok = fused_ops.rope_fused(torch.as_tensor(x), torch.as_tensor(y),
                                      torch.as_tensor(cos),
                                      torch.as_tensor(sin),
                                      interleaved=not neox)
        np.testing.assert_allclose(oq.numpy(), want, rtol=1e-6, atol=1e-6)
        wk = np.asarray(jax_rope(jnp.asarray(y), jnp.asarray(c4),
                                 jnp.asarray(s4), neox))
        np.testing.assert_allclose(ok.numpy(), wk, rtol=1e-6, atol=1e-6)


def test_interleaved_rope_backward_is_the_inverse_rotation():
    """rope_fused's backward with ``interleaved`` (K2 at -theta over the
    same pairs) is autograd's gradient of the plain rotation."""
    rng = np.random.default_rng(24)
    q = torch.tensor(rng.standard_normal((1, 5, 2, 8)), dtype=torch.float32,
                     requires_grad=True)
    k = torch.tensor(rng.standard_normal((1, 5, 1, 8)), dtype=torch.float32,
                     requires_grad=True)
    cos = torch.tensor(rng.standard_normal((5, 4)), dtype=torch.float32)
    sin = torch.tensor(rng.standard_normal((5, 4)), dtype=torch.float32)
    oq, ok = fused_ops.rope_fused(q, k, cos, sin, interleaved=True)
    gq, gk = torch.randn_like(oq), torch.randn_like(ok)
    dq, dk = torch.autograd.grad((oq * gq).sum() + (ok * gk).sum(), (q, k))
    rq, rk = fused_ops.rope_bwd_fused(gq, gk, cos, sin, interleaved=True)
    torch.testing.assert_close(dq, rq, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dk, rk, rtol=1e-6, atol=1e-6)


def test_int32_qkv_dequant_and_bias_match_jax():
    rng = np.random.default_rng(25)
    m = _mixed(rng)
    m["qkv"] = rng.integers(-1000, 1000, m["qkv"].shape).astype(np.int32)
    m["kc"] = rng.standard_normal(m["kc"].shape).astype(np.float32)
    m["vc"] = rng.standard_normal(m["vc"].shape).astype(np.float32)
    W = m["qkv"].shape[1]
    scale = rng.uniform(5e-4, 2e-3, W).astype(np.float32)
    bias = rng.standard_normal(W).astype(np.float32)
    kw = dict(num_heads=4, kv_num_heads=2, head_dim=32, block_size=4,
              max_q_len=5, use_neox_style=True)
    j = jax_blha(*(jnp.asarray(m[n]) for n in NAMES),
                 qkv_out_scale=jnp.asarray(scale),
                 qkv_bias=jnp.asarray(bias), **kw)
    p = _port({n: m[n] for n in NAMES}, **kw,
              qkv_out_scale=torch.as_tensor(scale),
              qkv_bias=torch.as_tensor(bias))
    assert p[0].dtype == np.float32
    np.testing.assert_allclose(p[1], np.asarray(j[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p[0], np.asarray(j[0]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ties_away", [True, False])
def test_shift_smooth_and_out_quant_match_jax(ties_away):
    """out_shift then out_smooth, then the int8 output quantization (at
    least 99.9% of the codes equal, none more than one apart: the same
    rounding boundary rule as the caches); and the epilogue alone."""
    rng = np.random.default_rng(26)
    m = _mixed(rng)
    m["kc"] = rng.standard_normal(m["kc"].shape).astype(np.float32)
    m["vc"] = rng.standard_normal(m["vc"].shape).astype(np.float32)
    shift = rng.standard_normal(4 * 32).astype(np.float32) * 0.1
    smooth = rng.uniform(0.5, 1.5, 4 * 32).astype(np.float32)
    kw = dict(num_heads=4, kv_num_heads=2, head_dim=32, block_size=4,
              max_q_len=5, use_neox_style=True, round_ties_away=ties_away)
    for quant in (True, False):
        extra = dict(has_out_quant=True, out_scale=1.3) if quant else {}
        j = jax_blha(*(jnp.asarray(m[n]) for n in NAMES),
                     out_shift=jnp.asarray(shift),
                     out_smooth=jnp.asarray(smooth), **extra, **kw)
        p = _port({n: m[n] for n in NAMES}, out_shift=torch.as_tensor(shift),
                  out_smooth=torch.as_tensor(smooth), **extra, **kw)
        want = np.asarray(j[0])
        if quant:
            assert p[0].dtype == want.dtype == np.int8
            diff = np.abs(p[0].astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
            assert np.abs(want).max() > 10        # the codes are not all 0
        else:
            np.testing.assert_allclose(p[0], want, rtol=2e-5, atol=2e-5)


def _bf16_steps_close(ours, ref):
    """bfloat16 outputs (as float32): none more than one bf16 step (of the
    larger magnitude) apart, at least 99.9% equal."""
    diff = np.abs(ours - ref)
    big = np.maximum(np.abs(ours), np.abs(ref))
    step = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert (diff <= step).all(), float((diff / step).max())
    assert (diff == 0).mean() >= 0.999, float((diff == 0).mean())


@pytest.mark.parametrize("what, cache", [
    ("epilogue", "bf16"), ("out_quant", "bf16"), ("both", "bf16"),
    ("both", "uint8")])
@pytest.mark.parametrize("ties_away", [True, False])
def test_shift_smooth_and_out_quant_match_jax_bf16(what, cache, ties_away):
    """Queue C9: the inputs of test_shift_smooth_and_out_quant_match_jax
    (seed 26) with qkv, caches and compute_dtype in bfloat16 in both
    packages.  The epilogue (shift then smooth), the int8 output
    quantization, or both, read the attention's float32 value and round
    once, as the reference does; ``cache`` "uint8" runs the same over a
    static int8 cache (K4-int8's plain version).  bf16 outputs at most one
    bf16 step apart and at least 99.9% equal (a float32 value within ~1e-7
    of a bf16 rounding boundary may round either way); int8 codes as the
    float32 test."""
    rng = np.random.default_rng(26)
    m = _mixed(rng)
    m["kc"] = rng.standard_normal(m["kc"].shape).astype(np.float32)
    m["vc"] = rng.standard_normal(m["vc"].shape).astype(np.float32)
    shift = rng.standard_normal(4 * 32).astype(np.float32) * 0.1
    smooth = rng.uniform(0.5, 1.5, 4 * 32).astype(np.float32)
    kw = dict(num_heads=4, kv_num_heads=2, head_dim=32, block_size=4,
              max_q_len=5, use_neox_style=True, round_ties_away=ties_away)
    extra = {}
    if what != "out_quant":
        extra.update(out_shift=shift, out_smooth=smooth)
    if what != "epilogue":
        extra.update(has_out_quant=True, out_scale=1.3)
    sc = {}
    if cache == "uint8":
        m["kc"] = rng.integers(0, 256, m["kc"].shape).astype(np.uint8)
        m["vc"] = rng.integers(0, 256, m["vc"].shape).astype(np.uint8)
        kq = rng.uniform(60, 120, 2).astype(np.float32)
        vq = rng.uniform(60, 120, 2).astype(np.float32)
        sc = dict(cache_k_quant_scales=kq, cache_v_quant_scales=vq,
                  cache_k_dequant_scales=(1 / kq).astype(np.float32),
                  cache_v_dequant_scales=(1 / vq).astype(np.float32))
        kw["cache_quant"] = "static"
    bf16 = [n for n in ("qkv", "kc", "vc") if m[n].dtype == np.float32]
    j = jax_blha(*(jnp.asarray(m[n], dtype=jnp.bfloat16) if n in bf16
                   else jnp.asarray(m[n]) for n in NAMES),
                 compute_dtype=jnp.bfloat16,
                 **{n: jnp.asarray(v) for n, v in {**extra, **sc}.items()
                    if isinstance(v, np.ndarray)},
                 **{n: v for n, v in extra.items()
                    if not isinstance(v, np.ndarray)}, **kw)
    args = [torch.as_tensor(np.array(m[n])) for n in NAMES]
    for i, n in enumerate(NAMES):
        if n in bf16:
            args[i] = args[i].to(torch.bfloat16)
    for i in (1, 2):
        args[i] = torch.cat([args[i], torch.zeros_like(args[i][:1])])
    p, _, _ = blha_attention(
        *args, compute_dtype=torch.bfloat16,
        **{n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for n, v in {**extra, **sc}.items()}, **kw)
    want = np.asarray(j[0])
    if what != "epilogue":
        assert p.dtype == torch.int8 and want.dtype == np.int8
        diff = np.abs(p.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        assert np.abs(want).max() > 10            # the codes are not all 0
    else:
        assert p.dtype == torch.bfloat16
        _bf16_steps_close(p.float().numpy(), want.astype(np.float32))


def test_build_padding_metadata_matches_jax():
    for lens in ([3, 0, 5, 1], [4], [2, 2]):
        for ours, ref in zip(build_padding_metadata(lens), jax_padding(lens)):
            assert ours.dtype == ref.dtype
            np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("D", [72, 128, 264, 640])
def test_int8_attention_plain_version_matches_jax_core(D):
    """K4-int8's plain version against the attention the JAX
    blha_attention computes in static mode (no rope): JAX writes this
    step's quantized K/V and attends through its gather, dequantization
    and full-precision overlay; the plain version is handed the caches it
    left, the unrotated q and this step's k and v.  A decode row, a
    prefill row and a continuing chunk; 4 heads over 2."""
    rng = np.random.default_rng(D)
    H, KV, bs = 4, 2, 8
    now = np.array([1, 6, 3], np.int32)
    dec = np.array([13, 0, 10], np.int32)
    B, P_ = 3, 3
    NB = B * P_ + 1
    bt = rng.permutation(NB)[:B * P_].reshape(B, P_).astype(np.int32)
    bt[0, 1] = NB + 3                     # outside the pool, keys 8-15 visible
    T = 12
    m = dict(qkv=rng.uniform(-1, 1, (T, (H + 2 * KV) * D)).astype(np.float32),
             kc=rng.integers(0, 256, (NB, KV, bs, D)).astype(np.uint8),
             vc=rng.integers(0, 256, (NB, KV, bs, D)).astype(np.uint8),
             enc=np.array([0, 6, 3], np.int32), dec=dec, now=now,
             cu=np.concatenate([[0], np.cumsum(now)]).astype(np.int32),
             bt=bt)
    kq = rng.uniform(60, 120, KV).astype(np.float32)
    vq = rng.uniform(60, 120, KV).astype(np.float32)
    m.update(cache_k_quant_scales=kq, cache_v_quant_scales=vq,
             cache_k_dequant_scales=(1 / kq).astype(np.float32),
             cache_v_dequant_scales=(1 / vq).astype(np.float32))
    j = _jax(m, num_heads=H, kv_num_heads=KV, head_dim=D, block_size=bs,
             max_q_len=6, use_neox_style=True, cache_quant="static")
    qkv = torch.as_tensor(m["qkv"])
    q = qkv[:, :H * D].reshape(T, H, D)
    k = qkv[:, H * D:(H + KV) * D].reshape(T, KV, D)
    v = qkv[:, (H + KV) * D:].reshape(T, KV, D)
    ints = [torch.as_tensor(m[n]) for n in ("dec", "now", "cu", "bt")]
    scales = [torch.as_tensor(m[n]) for n in SCALES[2:]]
    args = (q, k, v, torch.as_tensor(np.array(j[1])),
            torch.as_tensor(np.array(j[2])), *scales, *ints, 6)
    ours = _paged_attention_int8_ref(*args)
    np.testing.assert_allclose(ours.numpy(), j[0].reshape(T, H, D),
                               rtol=2e-5, atol=2e-5)
    # the wrapper takes the plain version for CPU tensors; static [KV]
    # scales equal the same scales expanded to [B, KV]
    wide = [s.expand(B, KV).contiguous() for s in scales]
    torch.testing.assert_close(
        paged_attention_int8(*args[:5], *wide, *ints, 6), ours)
    assert paged_int8_plan(T, B, 6, P_, bs, H, KV, D).kt in (8, 16, 32, 64)


# ----------------------------------------------------------------- engine
ENGINE = dict(max_batch_size=3, max_seq_len=96, block_size=8,
              token_budget=16)
COUNTERS = ("megasteps", "megasteps_mixed", "prefill_chunks",
            "prefill_tokens_computed", "prefix_hit_blocks")
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=13,
               logprobs=True)


def _pair(**cfg):
    """A 2-layer float32 JAX Llama (the reference's serving-test geometry,
    vocab 512, hidden 64) and the port's copy of its weights."""
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(11)
    jm = JaxLlama(JaxConfig(vocab_size=512, hidden_size=64,
                            intermediate_size=160, num_hidden_layers=2,
                            max_position_embeddings=256, **cfg))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = PortLlama(PortConfig(**dataclasses.asdict(jm.config)), device="cpu")
    return jm, load_numpy_state_dict(pm, sd)


@pytest.fixture(scope="module")
def mha():
    return _pair(num_attention_heads=2)


@pytest.fixture(scope="module")
def gqa():
    return _pair(num_attention_heads=4, num_key_value_heads=2)


def _drive(eng, wave):
    """Admit each (arrival step, prompt, n, sampling) as the engine steps;
    -> (tokens, logprobs) per request."""
    rids, nxt, steps = [], 0, 0
    while True:
        while nxt < len(wave) and wave[nxt][0] <= steps:
            _, prompt, n, sp = wave[nxt]
            rids.append(eng.add_request(prompt, max_new_tokens=n,
                                        sampling=sp or None))
            nxt += 1
        if eng.num_active == 0 and not eng.state_summary()["queue_depth"]:
            if nxt >= len(wave):
                break
            steps = wave[nxt][0]
            continue
        eng.step()
        steps += 1
    done, lps = eng.pop_finished(), eng.pop_token_logprobs()
    return [done[r] for r in rids], [lps.get(r, []) for r in rids]


WAVE = [(0, [3, 17, 101, 7, 250], 10, dict(logprobs=True)),
        (1, [40 + i for i in range(16)], 6, dict(logprobs=True)),
        (2, [7, 9, 11], 8, SAMPLED)]


@pytest.mark.parametrize("k", [1, 8])
def test_int8_engine_parity_with_jax(gqa, k):
    """Staggered arrivals (a 16-token prompt, the whole budget, waits for
    the decoding rows), a seeded sampled request: the port's int8 engine
    emits the JAX int8 engine's tokens, logprobs and counters, with the
    uint8 caches and scales it leaves; no mixed loop under int8."""
    jm, pm = gqa
    jeng = JaxEngine(jm, megastep_k=k, cache_quant="int8", **ENGINE)
    peng = PortEngine(pm, megastep_k=k, cache_quant="int8", device="cpu",
                      **ENGINE)
    assert peng.key_caches[0].dtype == torch.uint8
    assert peng.key_caches[0].shape[0] == peng.blocks.num_blocks + 1
    jt, jl = _drive(jeng, WAVE)
    pt, pl = _drive(peng, WAVE)
    assert pt == jt
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert {c: getattr(peng, c) for c in COUNTERS} == \
        {c: getattr(jeng, c) for c in COUNTERS}
    assert peng.megasteps_mixed == 0 and peng.prefill_chunks == 3
    if k > 1:
        assert peng.megasteps > 0
    for li in range(2):
        for n in ("kq", "vq", "kd", "vd"):
            np.testing.assert_allclose(
                peng.cache_scales[li][n].numpy(),
                np.asarray(jeng.cache_scales[li][n]), rtol=1e-6)
        _codes_close(peng.key_caches[li][:-1].numpy(),
                     np.asarray(jeng.key_caches[li]))


def _ref_greedy(jm, prompt, n):
    from paddle_tpu.models.generation import generate

    ids = P.to_tensor(np.asarray(prompt, np.int32)[None, :])
    out = generate(jm, ids, max_new_tokens=n, do_sample=False)
    return list(np.asarray(out.numpy()).reshape(-1))


def test_int8_paged_cache(mha):
    """The reference's test_int8_paged_cache on the port: uint8 blocks and
    per-(slot, kv-head) scales frozen at prefill, tokens equal to the JAX
    model's greedy ``generate``; the one-shot-prefill contract."""
    jm, pm = mha
    eng = PortEngine(pm, max_batch_size=2, max_seq_len=64, block_size=8,
                     token_budget=16, cache_quant="int8", device="cpu")
    assert eng.key_caches[0].dtype == torch.uint8
    p1, p2 = [3, 17, 101, 7, 250], [42, 5, 9]
    r1 = eng.add_request(p1, max_new_tokens=6)
    r2 = eng.add_request(p2, max_new_tokens=6)
    out = eng.run()
    assert out[r1] == _ref_greedy(jm, p1, 6)
    assert out[r2] == _ref_greedy(jm, p2, 6)
    assert (eng.cache_scales[0]["kd"].numpy() > 0).all()
    with pytest.raises(ValueError, match="one step"):
        eng.add_request(list(range(20)), max_new_tokens=2)


def test_int8_prefill_never_chunked_under_load(mha):
    """The reference's test: with a decoding row eating budget, an int8
    prefill of exactly the budget waits for a one-shot step, never
    chunks, and both requests decode the JAX model's greedy tokens."""
    jm, pm = mha
    eng = PortEngine(pm, max_batch_size=2, max_seq_len=64, block_size=8,
                     token_budget=8, cache_quant="int8", device="cpu")
    p1 = [3, 17, 101]
    r1 = eng.add_request(p1, max_new_tokens=10)
    eng.step()  # r1 prefills
    p2 = list(range(40, 48))
    r2 = eng.add_request(p2, max_new_tokens=4)
    out = eng.run()
    assert out[r1] == _ref_greedy(jm, p1, 10)
    assert out[r2] == _ref_greedy(jm, p2, 4)
    assert eng.prefill_chunks == 2 and eng.prefill_tokens_computed == 11


def test_int8_engine_rules(mha):
    """prefix_cache=True and cache_dtype refuse int8, "auto" turns the
    prefix cache off; with spec_k > 0 no verify arms; block transfer
    refuses the int8 cache."""
    _, pm = mha
    with pytest.raises(ValueError, match="prefix_cache"):
        PortEngine(pm, cache_quant="int8", prefix_cache=True, device="cpu",
                   **ENGINE)
    with pytest.raises(ValueError, match="cache_dtype"):
        PortEngine(pm, cache_quant="int8", cache_dtype="float32",
                   device="cpu", **ENGINE)
    eng = PortEngine(pm, cache_quant="int8", spec_k=4, device="cpu",
                     **ENGINE)
    assert not eng.prefix_cache_enabled
    assert not eng.state_summary()["prefix_cache"]["enabled"]
    prompt = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]     # an n-gram the drafter sees
    rid = eng.add_request(prompt, max_new_tokens=12)
    out = eng.run()[rid]
    assert len(out) == 12
    assert eng.spec_verify_forwards == 0 and eng.megasteps_mixed == 0
    plain = PortEngine(pm, cache_quant="int8", device="cpu", **ENGINE)
    rid2 = plain.add_request(prompt, max_new_tokens=12)
    assert plain.run()[rid2] == out
    with pytest.raises(ValueError, match="int8"):
        eng.export_blocks_packed([])


def test_int8_plan_rules():
    """K4-int8's plan from host sizes: no split where the grid fills the
    card's 132 SMs, up to 4 where it does not; key tiles shrink with D; a
    block never past 227 KB, for every D up to 2048 at 1, 4 and 16 query
    heads a KV head (or a ValueError); the tensor-core instance where
    bfloat16 allows it, on K4's plan."""
    decode = paged_int8_plan(8, 8, 1, 32, 16, 32, 32, 128)
    assert (decode.qt, decode.kt, decode.splits) == (1, 64, 1)
    assert decode.blocks == 256
    small = paged_int8_plan(8, 8, 1, 32, 16, 8, 2, 72)
    assert small.splits == 4 and small.chunk == 128 and small.blocks == 64
    assert paged_int8_plan(8, 8, 1, 32, 16, 8, 2, 640).kt == 8
    mixed = paged_int8_plan(256, 8, 256, 32, 16, 32, 32, 128)
    assert mixed.qt == 8 and mixed.splits == 1
    for D in range(8, 2049, 8):
        for G in (1, 4, 16):
            try:
                p = paged_int8_plan(256, 8, 256, 32, 16, 2 * G, 2, D)
            except ValueError:
                assert D * G > 4096
                continue
            assert p.smem <= 232448 and p.chunk % p.kt == 0
            assert p.chunk * p.splits >= 512 > p.chunk * (p.splits - 1)
    # the tensor-core instance: bfloat16 at D a multiple of 8 up to 256
    # with at most 64 query rows a tile, on K4's tiles and shared memory;
    # float32, D 100 or 264 and a group of 128 heads run SIMT
    bf = torch.bfloat16
    assert not any(p.tc for p in (decode, small, mixed))
    for D in range(8, 257, 8):
        for G in (1, 4, 8, 16, 64):
            for T, mq in ((8, 1), (256, 256), (72, 9)):
                p = paged_int8_plan(T, 8, mq, 32, 16, 2 * G, 2, D, bf)
                assert p.tc and p.kt == 64 and p.qt * G <= 64
                assert p.smem == _int8_smem_bytes(p.qt * G, D, p.kt,
                                                  p.splits, 8, p.chunk, 16,
                                                  tc=True) <= 232448
                assert p[:6] == tuple(paged_plan(T, 8, mq, 32, 16, 2 * G, 2,
                                                 D, bf))[:2] + tuple(
                    paged_plan(T, 8, mq, 32, 16, 2 * G, 2, D, bf))[3:]
    for args in ((8, 8, 1, 32, 16, 32, 32, 128, torch.float32),
                 (8, 8, 1, 32, 16, 8, 2, 100, bf),
                 (8, 8, 1, 32, 16, 8, 2, 264, bf),
                 (8, 1, 1, 32, 16, 128, 1, 128, bf)):
        assert not paged_int8_plan(*args).tc
    assert paged_int8_plan(8, 8, 1, 32, 16, 32, 32, 128, bf).tc
    with pytest.raises(ValueError, match="tensor-core"):
        _int8_plan(8, 1, 1, 32, 16, 128, 1, 128, bf, True)


@pytest.mark.parametrize("offset", [0, 1])
def test_int8_launch_plan_simt_for_misaligned_kv(offset):
    """The launch's plan: bfloat16 k and v as 16-byte aligned views of a
    packed qkv buffer take the tensor cores; the same views one element
    further on (2-byte aligned) take SIMT unforced, and a forced
    instance stays forced."""
    T, H, KV, D, bs, B, P_ = 4, 8, 2, 64, 16, 2, 4
    qkv = torch.zeros(T, (H + 2 * KV) * D + offset, dtype=torch.bfloat16)
    base = qkv[:, offset:]
    q = base[:, :H * D].reshape(T, H, D).contiguous()
    k = base[:, H * D:(H + KV) * D].view(T, KV, D)
    v = base[:, (H + KV) * D:].view(T, KV, D)
    caches = [torch.zeros(B * P_, KV, bs, D, dtype=torch.uint8)
              for _ in range(2)]
    bt = torch.zeros(B, P_, dtype=torch.int32)
    assert (k.data_ptr() % 16 == 0) == (offset == 0)
    plan = _int8_launch_plan(q, k, v, *caches, bt, 1)
    assert plan.tc == (offset == 0)
    assert plan == _int8_plan(T, B, 1, P_, bs, H, KV, D, torch.bfloat16,
                              offset == 0)
    assert not _int8_launch_plan(q, k, v, *caches, bt, 1, tc=False).tc
    assert _int8_launch_plan(q, k, v, *caches, bt, 1, tc=True).tc


@pytest.mark.parametrize("int8", [False, True])
def test_out_dtype_only_q_dtype_or_float32(int8):
    """K4's and K4-int8's ``out_dtype``: None or q's dtype give q's dtype,
    float32 the unrounded float32 output, anything else raises."""
    rng = np.random.default_rng(27)
    T, H, KV, D, bs, B, P_ = 3, 4, 2, 16, 4, 2, 3
    q = torch.as_tensor(rng.standard_normal((T, H, D)),
                        dtype=torch.float32).to(torch.bfloat16)
    kv = torch.as_tensor(rng.standard_normal((T, KV, D)),
                         dtype=torch.float32).to(torch.bfloat16)
    ints = (torch.tensor([5, 0], dtype=torch.int32),
            torch.tensor([1, 2], dtype=torch.int32),
            torch.tensor([0, 1, 3], dtype=torch.int32),
            torch.arange(B * P_, dtype=torch.int32).view(B, P_))
    if int8:
        caches = [torch.as_tensor(rng.integers(0, 256, (B * P_, KV, bs, D)),
                                  dtype=torch.uint8) for _ in range(2)]
        d = torch.full((KV,), 0.01)

        def call(od):
            return paged_attention_int8(q, kv, kv, *caches, d, d, *ints, 2,
                                        out_dtype=od)
    else:
        caches = [torch.as_tensor(rng.standard_normal((B * P_, KV, bs, D)),
                                  dtype=torch.float32).to(torch.bfloat16)
                  for _ in range(2)]

        def call(od):
            return paged_attention(q, *caches, *ints, 2, out_dtype=od)
    f32 = call(torch.float32)
    assert f32.dtype == torch.float32
    for od in (None, torch.bfloat16):
        got = call(od)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, f32.to(torch.bfloat16), rtol=0,
                                   atol=0)
    for od in (torch.float16, torch.int8, torch.float64):
        with pytest.raises(ValueError, match="out_dtype"):
            call(od)
