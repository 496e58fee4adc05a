"""Plain versions of the port's Hopper kernels K1-K3 against the JAX
functions they replace, on the CPU (K4, the paged attention, is held
against blha_attention in test_torch_paged_attention.py).

The JAX side runs its Pallas kernels as the JAX tests do on the CPU
(``interpret=True``) and, where it has one, its plain reference path too;
the port's wrappers take their plain PyTorch versions for CPU tensors.
Inputs come from a numpy seed and reach both packages as numpy.

Tolerances: float32 everywhere.  K1-K3 are elementwise or one row
reduction: 1e-5 abs / 1e-5 rel covers rsqrt/sigmoid/sum-order differences
between XLA and PyTorch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops.pallas import fused_norm as jfn
from paddle_tpu.ops.pallas import fused_ops as jfo
from paddle_tpu_torch.ops.hopper import fused_norm, fused_ops
from paddle_tpu_torch.ops.hopper.paged_attention import paged_attention

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128)])
def test_rms_norm_matches_pallas(shape):
    rng = np.random.default_rng(0)
    x, w = _np(rng, *shape), _np(rng, shape[-1])
    ours = fused_norm.rms_norm_fused(torch.as_tensor(x), torch.as_tensor(w),
                                     1e-6).numpy()
    for ref in (jfn.rms_norm_fused(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                   True),
                jfn._ref_rms(jnp.asarray(x), jnp.asarray(w), 1e-6)):
        np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128)])
def test_rms_norm_residual_matches_pallas(shape):
    rng = np.random.default_rng(1)
    x, r, w = _np(rng, *shape), _np(rng, *shape), _np(rng, shape[-1])
    out, res = fused_norm.rms_norm_residual_fused(
        torch.as_tensor(x), torch.as_tensor(r), torch.as_tensor(w), 1e-6)
    j_out, j_res = jfn.rms_norm_residual_fused(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(w), 1e-6, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(res.numpy(), np.asarray(j_res), **TOL)
    np.testing.assert_allclose(res.numpy(), x + r, **TOL)


def test_rope_matches_pallas_gqa_per_token():
    """GQA (H=4, KVH=2) with per-token cos/sin rows, as the engine calls
    it (B=1, S=T packed tokens at scattered absolute positions)."""
    rng = np.random.default_rng(2)
    T, H, KVH, D = 7, 4, 2, 16
    q, k = _np(rng, 1, T, H, D), _np(rng, 1, T, KVH, D)
    pos = rng.integers(0, 200, T)
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    fr = np.outer(pos, inv)
    cos, sin = np.cos(fr).astype(np.float32), np.sin(fr).astype(np.float32)
    oq, ok = fused_ops.rope_fused(*(torch.as_tensor(a)
                                    for a in (q, k, cos, sin)))
    jq, jk = jfo.rope_fused(*(jnp.asarray(a) for a in (q, k, cos, sin)),
                            True)
    rq, rk = jfo._rope_ref(*(jnp.asarray(a) for a in (q, k, cos, sin)))
    for ours, refs in ((oq, (jq, rq)), (ok, (jk, rk))):
        for ref in refs:
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_swiglu_matches_pallas():
    rng = np.random.default_rng(3)
    a, b = _np(rng, 16, 96), _np(rng, 16, 96)
    ours = fused_ops.swiglu_fused(torch.as_tensor(a), torch.as_tensor(b))
    ref = jfo.swiglu_fused(jnp.asarray(a), jnp.asarray(b), True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_cpu_tensors_take_plain_versions_without_launching():
    rng = np.random.default_rng(4)
    x = torch.as_tensor(_np(rng, 3, 32))
    before = (fused_norm.rms_norm_fused.launches,
              fused_norm.rms_norm_residual_fused.launches,
              fused_ops.rope_fused.launches, fused_ops.swiglu_fused.launches,
              paged_attention.launches)
    fused_norm.rms_norm_fused(x, x[0])
    fused_norm.rms_norm_residual_fused(x, x, x[0])
    fused_ops.swiglu_fused(x, x)
    q = x.reshape(1, 3, 2, 16)
    fused_ops.rope_fused(q, q, torch.ones(3, 8), torch.zeros(3, 8))
    after = (fused_norm.rms_norm_fused.launches,
             fused_norm.rms_norm_residual_fused.launches,
             fused_ops.rope_fused.launches, fused_ops.swiglu_fused.launches,
             paged_attention.launches)
    assert after == before
