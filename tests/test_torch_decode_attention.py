"""Kernels B2 (decode attention) and B3 (KV ring write): the port's plain
versions against the JAX package's Pallas kernels in ``interpret=True``,
on the CPU.  Inputs come from a numpy seed.

Tolerance: float32 rtol 1e-5 / atol 1e-5 for B2 (one softmax over up to
64 keys, summed in another order); B3 is a copy and is compared exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops.pallas.decode_attention import decode_attention as jdec
from paddle_tpu.ops.pallas.decode_attention import kv_ring_write as jwrite
from paddle_tpu.ops.pallas.decode_attention import ref_decode_attention
from paddle_tpu_torch.ops.hopper import decode_attention as da

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("pos", [0, 27, 63])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)])
def test_b2_plain_matches_pallas_interpret(pos, h, kvh):
    """pos 0, mid and L - 1 of a 64-row ring, MHA and GQA (rep 4)."""
    rng = np.random.default_rng(pos + h)
    B, L, D = 2, 64, 32
    q, kb, vb = _np(rng, B, 1, h, D), _np(rng, B, L, kvh, D), _np(rng, B, L,
                                                                  kvh, D)
    ref = jdec(jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb),
               jnp.int32(pos), block_l=16, interpret=True)
    ours = da.decode_attention(torch.as_tensor(q), torch.as_tensor(kb),
                               torch.as_tensor(vb),
                               torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(ref_decode_attention(
            jnp.asarray(q), jnp.asarray(kb), jnp.asarray(vb), pos)), **TOL)


def test_b3_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    B, L, KVH, D = 2, 16, 2, 32
    kb, vb = _np(rng, B, L, KVH, D), _np(rng, B, L, KVH, D)
    kn, vn = _np(rng, B, 1, KVH, D), _np(rng, B, 1, KVH, D)
    pos = 7
    jk = jwrite(jnp.asarray(kb), jnp.asarray(kn), jnp.int32(pos),
                interpret=True)
    jv = jwrite(jnp.asarray(vb), jnp.asarray(vn), jnp.int32(pos),
                interpret=True)
    pk, pv = torch.as_tensor(kb.copy()), torch.as_tensor(vb.copy())
    ok, ov = da.kv_ring_write(pk, pv, torch.as_tensor(kn),
                              torch.as_tensor(vn),
                              torch.tensor(pos, dtype=torch.int32))
    assert ok is pk and ov is pv        # in place
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("pos", [0, 5, 14])
def test_b3_rows_match_dynamic_update_slice(pos):
    """S = 4 rows at pos (the static prefill); pos 14 overruns the ring
    and is clamped to L - S, as dynamic_update_slice clamps it."""
    rng = np.random.default_rng(pos)
    B, L, KVH, D, S = 2, 16, 2, 16, 4
    kb, vb = _np(rng, B, L, KVH, D), _np(rng, B, L, KVH, D)
    kn, vn = _np(rng, B, S, KVH, D), _np(rng, B, S, KVH, D)
    p = jnp.int32(pos)
    jk = jax.lax.dynamic_update_slice(jnp.asarray(kb), jnp.asarray(kn),
                                      (0, p, 0, 0))
    jv = jax.lax.dynamic_update_slice(jnp.asarray(vb), jnp.asarray(vn),
                                      (0, p, 0, 0))
    pk, pv = torch.as_tensor(kb.copy()), torch.as_tensor(vb.copy())
    da.kv_ring_write(pk, pv, torch.as_tensor(kn), torch.as_tensor(vn),
                     torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_cpu_tensors_take_the_plain_versions_without_launching():
    before = (da.decode_attention.launches, da.kv_ring_write.launches)
    ring = torch.zeros(1, 8, 1, 16)
    pos = torch.tensor(3, dtype=torch.int32)
    da.kv_ring_write(ring, ring.clone(), torch.ones(1, 1, 1, 16),
                     torch.ones(1, 1, 1, 16), pos)
    out = da.decode_attention(torch.ones(1, 1, 2, 16), ring, ring, pos)
    assert out.shape == (1, 1, 2, 16)
    assert (da.decode_attention.launches, da.kv_ring_write.launches) == before
