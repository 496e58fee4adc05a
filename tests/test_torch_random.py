"""The port's threefry key chain (paddle_tpu_torch/framework/random.py)
against jax.random, on the CPU: keys, folds and raw bits bit for bit;
uniforms bit for bit; Gumbel noise within 1e-6 (float32 logs on both
sides, which may differ by an ulp); categorical draws and top-p sampling
token for token; and the Generator stream against paddle_tpu's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as P
from paddle_tpu.framework.random import Generator as JaxGenerator
from paddle_tpu.tensor.search import top_p_sampling as jax_top_p
from paddle_tpu_torch.framework import random as R
from paddle_tpu_torch.tensor.search import top_p_sampling

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 123456789, 2 ** 31 - 1, 2 ** 32 - 1, -5]
SHAPES = [(), (1,), (3,), (4, 5), (2, 3, 7)]


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_are_bit_identical(seed):
    np.testing.assert_array_equal(R.key(seed).numpy(),
                                  _words(jax.random.key(seed)))
    for data in (0, 1, 5, 2 ** 31 - 1, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            R.fold_in(R.key(seed), data).numpy(),
            _words(jax.random.fold_in(jax.random.key(seed), data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_and_gumbel_match(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 3)
    pk = R.fold_in(R.key(seed), 3)
    np.testing.assert_array_equal(
        R.random_bits(pk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, dtype=jnp.uint32)).astype(
            np.int64))
    np.testing.assert_array_equal(R.uniform(pk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    np.testing.assert_array_equal(
        R.uniform(pk, shape, -2.0, 3.0).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0)))
    np.testing.assert_allclose(R.gumbel(pk, shape).numpy(),
                               np.asarray(jax.random.gumbel(jk, shape)),
                               rtol=1e-6, atol=1e-6)


def test_batched_categorical_matches_vmapped_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((16, 301)) * 2).astype(np.float32)
    seeds = rng.integers(0, 2 ** 31, 16).astype(np.int32)
    spos = rng.integers(0, 1000, 16).astype(np.int32)
    keys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    p))(seeds, spos)
    ref = jax.vmap(jax.random.categorical)(keys, logits)
    ours = R.categorical(R.fold_in(R.key(torch.as_tensor(seeds)),
                                   torch.as_tensor(spos)),
                         torch.as_tensor(logits))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_generator_stream_matches_paddle_tpu():
    jg, pg = JaxGenerator(11), R.Generator(11)
    for _ in range(4):
        np.testing.assert_array_equal(pg.next_key().numpy(),
                                      _words(jg.next_key()))
    assert pg.get_state() == jg.get_state() == (11, 4)
    pg.manual_seed(3)
    assert pg.get_state() == (3, 0)


def test_top_p_sampling_matches_jax():
    rng = np.random.default_rng(1)
    z = rng.standard_normal((5, 64)) * 2
    probs = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    ps = np.array([0.9, 0.5, 1.0, 0.2, 0.75], np.float32)
    gen = R.Generator(5)
    for _ in range(3):       # P.seed(5) and Generator(5): the same keys
        if gen.get_state()[1] == 0:
            P.seed(5)
        jv, ji = jax_top_p(P.to_tensor(probs), P.to_tensor(ps))
        pv, pi = top_p_sampling(torch.as_tensor(probs), torch.as_tensor(ps),
                                gen)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji._value))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv._value))
    assert gen.get_state() == (5, 3)
