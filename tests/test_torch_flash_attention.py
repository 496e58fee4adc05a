"""Kernel B1's plain version and the port's attention functionals against
the JAX package, on the CPU.

B1 (``paddle_tpu_torch/ops/hopper/flash_attention.py``) is held against the
Pallas forward ``_pallas_fwd`` run in ``interpret=True`` and against the
jnp fallback ``_ref_fwd_impl`` (output and logsumexp), with causal on and
off, ``Sq != Sk`` (including causal rows that see no key), GQA, and the
port's query offset against the reference's static-ring mask.  The port's
``F.flash_attention`` / ``F.scaled_dot_product_attention`` are held
against JAX's, masked and unmasked.  Inputs come from a numpy seed.

Tolerance: float32 rtol 1e-5 / atol 1e-5 — one softmax over a few dozen
keys, summed in a different order by XLA and PyTorch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas.flash_attention import _pallas_fwd
from paddle_tpu.ops.pallas.flash_attention import _ref_fwd_impl as jax_ref
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import flash_attention as fa

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,rep", [(16, 16, 1), (16, 32, 2), (32, 16, 1),
                                       (8, 24, 4)])
def test_b1_plain_matches_pallas_interpret(causal, sq, sk, rep):
    """[BH, S, D] blocks with kv_rep query heads per KV head; causal with
    sq > sk leaves the first rows without a key (zeros)."""
    rng = np.random.default_rng(sq * 100 + sk + rep)
    bhk, d = 2, 32
    q, k, v = _np(rng, bhk * rep, sq, d), _np(rng, bhk, sk, d), _np(
        rng, bhk, sk, d)
    scale = 1.0 / np.sqrt(d)
    jo, jl = _pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, scale, 8, 8, interpret=True, kv_rep=rep)
    po, pl = fa.block_fwd(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), causal, scale, kv_rep=rep)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    # and the jnp fallback the reference uses off the TPU
    ro, rl = jax_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, 0),
                     jnp.repeat(jnp.asarray(v), rep, 0), causal, scale)
    np.testing.assert_allclose(po.numpy(), np.asarray(ro), **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    if causal and sq > sk:
        assert not po.numpy()[:, :sq - sk].any()


# the tile table's head-dim classes (the tensor-core instances take D 64,
# 128 and 256) and a GQA group of 4 at D 128; rows 24 vs 40 keys make
# ragged tiles and, causal with Sq > Sk, rows that see no key
TILE_EDGE_CASES = [(d, c, 1, 16, 24) for d in (64, 128, 256)
                   for c in (False, True)] + [(128, True, 4, 16, 16),
                                              (128, True, 1, 24, 16)]


@pytest.mark.parametrize("d,causal,rep,sq,sk", TILE_EDGE_CASES)
def test_b1_plain_matches_pallas_at_the_tile_table_head_dims(d, causal, rep,
                                                             sq, sk):
    """The semantics the card's bf16 instances are held to (chip_smoke.py
    compares each with this plain version): the plain B1 against
    ``_pallas_fwd(interpret=True)`` at each head-dim class of
    ``autotune.INSTANCES``."""
    rng = np.random.default_rng(d + 10 * causal + rep + sq)
    bhk = 2
    q, k, v = _np(rng, bhk * rep, sq, d), _np(rng, bhk, sk, d), _np(
        rng, bhk, sk, d)
    scale = 1.0 / np.sqrt(d)
    jo, jl = _pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal, scale, 8, 8, interpret=True, kv_rep=rep)
    po, pl = fa.block_fwd(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), causal, scale, kv_rep=rep)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("pos", [0, 5, 20])
def test_query_offset_matches_the_static_ring_mask(pos):
    """The static prefill: queries at pos .. pos + s - 1 over a ring of L
    rows (cols <= pos + i), with pos a 0-d int32 tensor, equals the
    reference's masked SDPA over the ring (_static_cache_attn)."""
    rng = np.random.default_rng(pos)
    B, s, L, H, KVH, D = 2, 6, 32, 4, 2, 16
    q, k, v = _np(rng, B, s, H, D), _np(rng, B, L, KVH, D), _np(rng, B, L,
                                                                KVH, D)
    rows = pos + np.arange(s)[:, None]
    mask = np.where(np.arange(L)[None, :] <= rows, 0.0, -1e30)[None, None]
    ref = JF.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        attn_mask=jnp.asarray(mask, jnp.float32))
    ours = fa.flash_attention_fwd(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=True,
        q_offset=torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref._value), **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kvh", [4, 2])
def test_functional_flash_attention_matches_jax(causal, kvh):
    rng = np.random.default_rng(kvh + causal)
    q, k, v = _np(rng, 2, 9, 4, 16), _np(rng, 2, 9, kvh, 16), _np(rng, 2, 9,
                                                                   kvh, 16)
    ref, _ = JF.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal)
    ours, sm = F.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                 causal=causal)
    assert sm is None
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref._value), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_functional_sdpa_matches_jax(masked):
    """Unmasked causal with sq < sk (the growing cache: bottom-right), and
    an explicit additive mask, which both sides take to the plain path."""
    rng = np.random.default_rng(7)
    q, k, v = _np(rng, 2, 3, 4, 16), _np(rng, 2, 11, 2, 16), _np(rng, 2, 11,
                                                                  2, 16)
    mask = None
    if masked:
        mask = np.where(rng.random((2, 1, 3, 11)) < 0.7, 0.0,
                        -1e30).astype(np.float32)
        mask[..., 0] = 0.0
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    pargs = [torch.as_tensor(a) for a in (q, k, v)]
    ref = JF.scaled_dot_product_attention(
        *jargs, attn_mask=None if mask is None else jnp.asarray(mask),
        is_causal=not masked)
    ours = F.scaled_dot_product_attention(
        *pargs, attn_mask=None if mask is None else torch.as_tensor(mask),
        is_causal=not masked)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref._value), **TOL)


def test_dropout_is_refused_while_training():
    """Refused before the port had a random stream; now computed: dropout
    0.1 while training takes the plain attention with the default
    generator's mask, the reference's output for the same seed (the key
    drawn in the same place), and in eval the kernel path."""
    import paddle_tpu as P
    from paddle_tpu_torch.framework import random as prand

    rng = np.random.default_rng(3)
    q, k, v = (_np(rng, 2, 16, 2, 8) for _ in range(3))
    P.seed(11)
    prand.seed(11)
    ref, _ = JF.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                dropout=0.1, causal=True)
    ours, _ = F.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                dropout=0.1, causal=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref._value), **TOL)
    # a mask was drawn: the output is not the undropped one
    plain, _ = F.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                 dropout=0.1, causal=True, training=False)
    assert not torch.allclose(ours, plain)
    assert prand.get_rng_state() == (11, 1)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = fa.flash_attention_fused.launches
    x = torch.randn(1, 4, 2, 16)
    out, lse = fa.flash_attention_fused(x, x, x, causal=True)
    assert out.shape == x.shape and lse.shape == (1, 2, 4)
    assert fa.flash_attention_fused.launches == before
