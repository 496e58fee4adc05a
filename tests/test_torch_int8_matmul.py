"""Kernel B7's plain version and the port's weight-only quantization tier
against the JAX package, on the CPU.

The JAX side runs ``int8_matmul`` as its own tests do on the CPU
(``interpret=True``: the Pallas kernel where its tiling applies, its
dequantize-then-matmul fallback elsewhere) and the reference
``quantization`` functions; the port's ``int8_matmul`` takes its plain
version for CPU tensors.  Inputs and weights come from a numpy seed and
reach both packages as numpy (bfloat16 through ml_dtypes, by raw bits).

Tolerances: float32 products at kernel shapes differ only in summation
order (1e-5 of the largest |out|); bfloat16 outputs are one float32 sum
rounded to 8 bits on both sides, so they may differ by one bf16 ulp
(2^-7 relative).  At the fallback's shapes the reference scales the weight
before the product in x's dtype: float32 1e-5, bfloat16 (its scale rounded
to bf16 too) 2^-6 of the largest |out|.  Quantized weights are compared
bit for bit.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu import quantization as jq
from paddle_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul
from paddle_tpu_torch import quantization as pq
from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul

torch.set_num_threads(2)

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _quantized(rng, k, n):
    """int8 weight [k, n] and float32 scales, as weight_quantize makes
    them."""
    w = rng.standard_normal((k, n)).astype(np.float32)
    s = np.maximum(np.abs(w).max(0), 1e-9) / 127.0
    q = np.clip(np.round(w / s), -128, 127).astype(np.int8)
    return q, s.astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("x_shape", [(16, 256), (2, 4, 256)])
def test_plain_b7_matches_pallas_kernel(x_shape, dtype):
    rng = np.random.default_rng(0)
    npdt, tdt = DTYPES[dtype]
    x = rng.standard_normal(x_shape).astype(np.float32).astype(npdt)
    q, s = _quantized(rng, 256, 128)
    ref = _f32(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                               jnp.asarray(s), interpret=True))
    ours = int8_matmul(_torch(x), torch.from_numpy(q), torch.from_numpy(s))
    assert ours.dtype == tdt and tuple(ours.shape) == x_shape[:-1] + (128,)
    big = np.abs(ref).max()
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_f32(ours), ref, rtol=rtol, atol=1e-5 * big)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_b7_matches_fallback_at_odd_shapes(dtype):
    rng = np.random.default_rng(1)
    npdt, _ = DTYPES[dtype]
    x = rng.standard_normal((3, 100)).astype(np.float32).astype(npdt)
    q, s = _quantized(rng, 100, 2)
    ref = _f32(jax_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                               jnp.asarray(s), interpret=True))
    ours = _f32(int8_matmul(_torch(x), torch.from_numpy(q),
                            torch.from_numpy(s)))
    tol = (1e-5 if dtype == "float32" else 2.0 ** -6) * np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


def test_x_gradient_matches_jax_and_weights_get_none():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    q, s = _quantized(rng, 256, 128)
    jq_, js = jnp.asarray(q), jnp.asarray(s)
    dref = jax.grad(lambda v: jnp.sum(jnp.tanh(
        jax_int8_matmul(v, jq_, js, interpret=True))))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    qt, st = torch.from_numpy(q), torch.from_numpy(s).requires_grad_()
    torch.tanh(int8_matmul(xt, qt, st)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dref), rtol=1e-5,
                               atol=1e-5)
    assert st.grad is None


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(64, 48), (256, 130)])
def test_weight_quantize_int8_is_the_reference_bit_for_bit(shape, dtype):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[:, 5] = 0.0                          # a zero column: the 1e-9 floor
    w = w.astype(DTYPES[dtype][0])
    rq, rs = jq.weight_quantize(w)
    q, s = pq.weight_quantize(_torch(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq._value))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(rs._value).view(np.int32))


def test_weight_quantize_fp8_matches_the_reference_bits():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((128, 64)) * 0.05).astype(np.float32)
    rq, rs = jq.weight_quantize(w, algo="weight_only_fp8")
    q, s = pq.weight_quantize(torch.from_numpy(w), algo="fp8")
    assert q.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(
        q.view(torch.uint8).numpy(), np.asarray(rq._value).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs._value))


def test_unknown_algo_raises():
    w = np.ones((4, 4), np.float32)
    with pytest.raises(ValueError, match="unrecognized algo"):
        jq.weight_quantize(w, algo="weight_only_int4")
    with pytest.raises(ValueError, match="unrecognized algo"):
        pq.weight_quantize(torch.from_numpy(w), algo="weight_only_int4")


def test_weight_dequantize_matches_the_reference():
    import paddle_tpu as P

    rng = np.random.default_rng(5)
    q, s = _quantized(rng, 32, 16)
    ref = jq.weight_dequantize(P.to_tensor(q), P.to_tensor(s)).numpy()
    ours = pq.weight_dequantize(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("algo", ["int8", "fp8"])
def test_weight_only_linear_with_bias_matches_the_reference(algo):
    import paddle_tpu as P

    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    rq, rs = jq.weight_quantize(w, algo=algo)
    ref = jq.weight_only_linear(P.to_tensor(x), rq, P.to_tensor(b), rs,
                                weight_dtype=algo).numpy()
    q, s = pq.weight_quantize(torch.from_numpy(w), algo=algo)
    ours = pq.weight_only_linear(torch.from_numpy(x), q, torch.from_numpy(b),
                                 s, weight_dtype=algo)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_refuses_other_dtypes_and_launches_nothing_on_the_cpu():
    q = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(8)
    before = int8_matmul.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        int8_matmul(torch.zeros(4, 16, dtype=torch.float16), q, s)
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(torch.zeros(4, 16), q.int(), s)
    with pytest.raises(ValueError, match="scale"):
        int8_matmul(torch.zeros(4, 16), q, s.double())
    out = int8_matmul(torch.ones(4, 16), q, s)
    assert tuple(out.shape) == (4, 8) and int8_matmul.launches == before


def test_strided_rows_are_read_in_place():
    """The classifier head's input x[:, 0] has rows S * H apart."""
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.standard_normal((4, 6, 32)).astype(np.float32))
    q, s = _quantized(rng, 32, 2)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    np.testing.assert_array_equal(int8_matmul(h[:, 0], qt, st).numpy(),
                                  int8_matmul(h[:, 0].contiguous(), qt,
                                              st).numpy())
