"""Queue C12: K4 over a cache whose dtype is not q's, on the CPU.

A ``ServingEngine`` whose ``cache_dtype`` is not its model's dtype stores
k and v in the cache's dtype and attends in float32 (the reference's
``paddle_tpu/inference/serving.py:596-611`` and
``paddle_tpu/ops/paged_attention.py:231-232, 255-270``).  On the card the
port's K4 now takes both mixes (a float32 q over bfloat16 pools in a
kernel instance of its own, a bfloat16 q over float32 pools widened to
float32 by the wrapper); here every wrapper runs its plain version, which
the card holds the kernel to.  Asserted against the JAX package on the
same numpy weights and inputs:

* a float32 port engine over a bfloat16 cache and a bfloat16 engine over
  a float32 cache against the JAX ``ServingEngine`` with the same
  ``cache_dtype``, on test_torch_serving.py's waves (staggered arrivals,
  chunked prefill, a prefix hit, an EOS): tokens exact, scheduling
  counters equal, logprobs rtol 1e-4 / atol 1e-5 in float32 and within
  one bfloat16 step of the logits' scale (2^-7 of the largest |logprob|,
  at least 2^-7) for the bfloat16 model, whose projections both
  packages round to bfloat16 after summing in their own orders;
* the public ``block_multihead_attention`` with ``compute_dtype``
  float32 over bfloat16 pools, and bfloat16 over float32 pools, with
  pre-caches (in the pools' dtype, as the reference casts them) and an
  encoder mask, against the JAX op: the pools written bit for bit (the
  same rounding of the same k and v), outputs rtol = atol = 2e-5 in
  float32 and, in bfloat16, one bf16 step apart and at least 99.9% equal;
* ``paged_plan``'s ``cache_dtype``: the SIMT ring counted at the width it
  is staged at (bfloat16 rows under a float32 q), no tensor-core
  instance for a mix, and the wide instance past 512 columns as for
  either dtype.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.incubate.nn.functional import block_multihead_attention as \
    ref_blha
from paddle_tpu.inference import ServingEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.incubate.nn.functional import block_multihead_attention
from paddle_tpu_torch.inference.serving import ServingEngine as PortEngine
from paddle_tpu_torch.models.llama import LlamaConfig as PortConfig
from paddle_tpu_torch.models.llama import LlamaForCausalLM as PortLlama
from paddle_tpu_torch.models.llama import load_numpy_state_dict
from paddle_tpu_torch.ops.hopper import paged_attention as pa
from test_torch_int8_cache import _bf16_steps_close
from test_torch_serving import COUNTERS, ENGINE, WAVE1, WAVE2, _drive

torch.set_num_threads(2)

MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256)


def _pair(dtype, seed):
    """A JAX Llama of ``MODEL`` in ``dtype`` and its port twin (the same
    numpy weights)."""
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(seed)
    jm = JaxLlama(JaxConfig(**MODEL, dtype=dtype))
    if dtype == "bfloat16":
        jm.bfloat16()
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = PortLlama(PortConfig(**dataclasses.asdict(jm.config)), device="cpu")
    return jm, load_numpy_state_dict(pm, sd)


@pytest.mark.parametrize("model_dtype, cache_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("k", [1, 8])
def test_engine_over_a_cache_of_the_other_dtype(model_dtype, cache_dtype, k):
    jm, pm = _pair(model_dtype, 21)
    free, _ = _drive(JaxEngine(jm, megastep_k=k, cache_dtype=getattr(
        jnp, cache_dtype), **ENGINE), [WAVE1])
    eos = {2: free[2][2]}
    jeng = JaxEngine(jm, megastep_k=k, cache_dtype=getattr(jnp, cache_dtype),
                     **ENGINE)
    peng = PortEngine(pm, megastep_k=k, cache_dtype=cache_dtype,
                      device="cpu", **ENGINE)
    assert peng.key_caches[0].dtype == getattr(torch, cache_dtype)
    jt, jl = _drive(jeng, [WAVE1, WAVE2], eos)
    pt, pl = _drive(peng, [WAVE1, WAVE2], eos)
    assert pt == jt
    assert {c: getattr(peng, c) for c in COUNTERS} == \
        {c: getattr(jeng, c) for c in COUNTERS}
    for a, b in zip(pl, jl):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if model_dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        elif len(b):
            step = 2.0 ** -7 * max(1.0, float(np.abs(b).max()))
            assert float(np.abs(a - b).max()) <= step


def _blha_case(rng, pools, compute):
    """A prefill of 8 and 5 tokens after 6 and 0 cached ones, GQA 4 / 2,
    D 32, over pools of ``pools``, with 3-key pre-caches (in the pools'
    dtype) and an encoder mask; -> (reference's out, kc, vc, port's out,
    kc, vc) as float32 numpy."""
    H, KV, D, BS, B = 4, 2, 32, 8, 2
    bt = np.arange(B * 3, dtype=np.int32).reshape(B, 3)
    kc = rng.standard_normal((B * 3, KV, BS, D)).astype(np.float32)
    vc = rng.standard_normal((B * 3, KV, BS, D)).astype(np.float32)
    now, dec = [8, 5], [6, 0]
    qkv = rng.uniform(-1, 1, (13, (H + 2 * KV) * D)).astype(np.float32)
    pre_k = rng.standard_normal((B, KV, 3, D)).astype(np.float32)
    pre_v = rng.standard_normal((B, KV, 3, D)).astype(np.float32)
    mask = rng.uniform(-2, 0, (B, 1, 8, 17)).astype(np.float32)
    cu = np.array([0, 8, 13], np.int32)
    ints = [np.asarray(x, np.int32) for x in (now, dec, now)]
    jdt, tdt = getattr(jnp, pools), getattr(torch, pools)

    def j(x, dt=None):
        return P.to_tensor(jnp.asarray(x, dt) if dt is not None else x)

    r = ref_blha(j(qkv), j(kc, jdt), j(vc, jdt), *(j(x) for x in ints),
                 None, None, j(cu), j(cu), j(bt), block_size=BS,
                 pre_key_cache=j(pre_k, jdt), pre_value_cache=j(pre_v, jdt),
                 mask=j(mask), compute_dtype=compute)
    tk = torch.as_tensor(kc).to(tdt)
    tv = torch.as_tensor(vc).to(tdt)
    out, _, _, _ = block_multihead_attention(
        torch.as_tensor(qkv), tk, tv, *(torch.as_tensor(x) for x in ints),
        None, None, torch.as_tensor(cu), torch.as_tensor(cu),
        torch.as_tensor(bt), block_size=BS,
        pre_key_cache=torch.as_tensor(pre_k).to(tdt),
        pre_value_cache=torch.as_tensor(pre_v).to(tdt),
        mask=torch.as_tensor(mask), compute_dtype=compute)
    assert out.dtype == getattr(torch, compute)

    def f32(x):
        return np.asarray(jnp.asarray(x._value, jnp.float32))

    return (f32(r[0]), f32(r[2]), f32(r[3]), out.float().numpy(),
            tk.float().numpy(), tv.float().numpy())


@pytest.mark.parametrize("pools, compute", [
    ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_public_op_over_pools_of_the_other_dtype(pools, compute):
    ro, rk, rv, po, pk, pv = _blha_case(np.random.default_rng(12), pools,
                                        compute)
    np.testing.assert_array_equal(pk, rk)
    np.testing.assert_array_equal(pv, rv)
    if compute == "float32":
        np.testing.assert_allclose(po, ro, rtol=2e-5, atol=2e-5)
    else:
        _bf16_steps_close(po, ro)


def test_plan_counts_the_staged_width():
    """A float32 q over bfloat16 pools stages the ring in bf16 rows: half
    the float32 ring's bytes, so deeper or wider rings fit where float32's
    do not; the tensor cores take only bfloat16 over bfloat16."""
    f32, bf = torch.float32, torch.bfloat16
    for D in (72, 128, 256, 512):
        for qt in (1, 8):
            for cache, es in ((bf, 2), (None, 4)):
                p = pa._plan(8 * qt, 8, qt, 32, 16, 32, 8, D, f32,
                             cache_dtype=cache)
                assert p.smem == pa._smem_bytes(
                    False, p.qt * 4, D, es, p.kt, p.stages, p.splits, 8,
                    p.chunk, 16) <= pa.SMEM_PER_BLOCK
                row = pa._row_chunks(pa._ceil(D, pa.VEC) * pa.VEC, es) * 16
                assert 2 * p.stages * p.kt * row <= pa.STAGE_BYTES
    # at D 128 the float32 ring takes 32-key tiles; the bf16 one 64
    assert pa.paged_plan(8, 8, 1, 32, 16, 32, 32, 128, f32).kt == 32
    assert pa.paged_plan(8, 8, 1, 32, 16, 32, 32, 128, f32,
                         cache_dtype=bf).kt == 64
    # no tensor-core plan for a mix: a bf16 q over bf16 pools takes 64-key
    # tiles and a ring of 2; the mix of float32 q over them the SIMT ring
    tc = pa.paged_plan(8, 8, 1, 32, 16, 32, 32, 128, bf)
    assert (tc.kt, tc.stages) == (64, 2)
    assert pa.paged_plan(8, 8, 1, 32, 16, 32, 32, 128, f32,
                         cache_dtype=bf).stages == 3
    # past 512 columns the wide instance, whatever the pools' dtype
    wide = pa.paged_plan(8, 8, 1, 32, 16, 8, 2, 640, f32, cache_dtype=bf)
    assert wide == pa.paged_plan(8, 8, 1, 32, 16, 8, 2, 640, f32)
    assert (wide.kt, wide.stages, wide.splits) == (pa.wide.KEYS, 1, 1)


def test_pre_args_take_the_caches_dtype():
    """K4's pre-caches come in the pools' dtype (blha_attention hands them
    over so); K4-int8's in q's."""
    q = torch.zeros(4, 8, 32)
    pre = torch.zeros(2, 2, 3, 32, dtype=torch.bfloat16)
    _, _, Lp = pa._pre_args("t", q, pre, pre, 2, 2, torch.bfloat16)
    assert Lp == 3
    with pytest.raises(ValueError, match="bfloat16"):
        pa._pre_args("t", q, pre.float(), pre.float(), 2, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        pa._pre_args("t", q, pre, pre, 2, 2)
