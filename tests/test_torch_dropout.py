"""The port's dropout (``paddle_tpu_torch/nn/functional.py``,
``nn.Dropout``, the encoder layers while training) against the JAX
package's, on the CPU.

- Masks bit for bit: ``framework.random.bernoulli`` against
  ``jax.random.bernoulli`` over shapes and rates, and ``dropout`` (with
  ``axis``, both modes, float32 and bfloat16), ``dropout2d``,
  ``dropout3d`` and ``alpha_dropout`` against the reference's functionals
  from the same seed: outputs equal exactly.
- Attention dropout: ``scaled_dot_product_attention`` (with and without a
  mask) and ``flash_attention`` at dropout 0.1 while training, the plain
  attention with the step's mask (float32: 1e-5; bfloat16: the
  probabilities are rounded in q's dtype in both, 1e-2 of the largest
  |out|).
- A recomputed segment (``torch.utils.checkpoint`` with the Llama model's
  ``_recompute_contexts``) draws the forward's masks again, so its
  gradients equal the plain run's bit for bit.
- A 2-layer BERT classifier (bench_ladder.py's ``BertClassifier`` at
  narrow width: ``TransformerEncoderLayer(dropout=0.1, activation=
  "gelu")``) through 3 ``TrainStep``s of AdamW against the reference's
  ``TrainStep``: the same masks from the same seed, so float32 losses
  agree to 1e-5 relative and every parameter to 1e-4 of its tensor's
  largest |w| for all but 1e-3 of its elements (all but k_proj's bias,
  whose gradient is rounding noise), and within 2 lr steps where Adam's
  sign of a near-zero gradient may differ; bfloat16 with
  ``multi_precision`` (the types of bench_ladder's accelerator run) to
  2e-2 relative in the losses, one bf16 ulp of each tensor's largest |w|
  plus 2 lr steps at the most and, for each weight matrix, one bf16 ulp of
  its largest |w| for all but 1e-2 of its elements (the worst has 0.68%
  outside; a bias starts at 0, so its largest |w| is a few lr steps and
  says nothing of its rounding).  Adam's state, tensor by tensor but for
  k_proj's bias: the step count equal, moment1 and moment2 within 1e-4
  (float32) or 0.15 (bfloat16) of the reference's norm, and the update
  (the master weight minus its start) within 1e-3 or 0.3 of the
  reference's update's norm (measured worst: 3.7e-6 and 4.1e-5 in float32,
  7.3e-2 and 0.19 in bfloat16).
"""
import numpy as np
import pytest
import torch

import jax
import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.framework import random as prand
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.llama import _recompute_contexts
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.transformer import (
    TransformerEncoder,
    TransformerEncoderLayer,
)
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)


def _seed(s):
    P.seed(s)
    prand.seed(s)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(a, dtype="float32"):
    return torch.as_tensor(a).to(getattr(torch, dtype))


def _jax(a, dtype="float32"):
    return P.to_tensor(a).astype(dtype)


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if isinstance(t, P.Tensor):
        return np.asarray(t.astype("float32")._value)
    return np.asarray(t).astype(np.float32)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 1e-3])
@pytest.mark.parametrize("shape", [(1,), (7, 13), (2, 3, 128, 128),
                                   (4097,)])
def test_bernoulli_equals_jax_bit_for_bit(shape, p):
    for seed, counter in ((0, 1), (7, 3), (2 ** 31 + 5, 12)):
        jkey = jax.random.fold_in(jax.random.key(seed), counter)
        ref = np.asarray(jax.random.bernoulli(jkey, p, shape))
        ours = prand.bernoulli(prand.fold_in(prand.key(seed), counter), p,
                               shape).numpy()
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 0, [1, 2], -1])
def test_dropout_equals_the_reference_bit_for_bit(axis, mode, dtype):
    x = _x(1, 3, 5, 17)
    outs = []
    for seed in (3, 4):
        _seed(seed)
        ref = JF.dropout(_jax(x, dtype), 0.3, axis=axis, mode=mode)
        ours = F.dropout(_port(x, dtype), 0.3, axis=axis, mode=mode)
        assert ours.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_f32(ours), _f32(ref))
        outs.append(_f32(ours))
    assert not np.array_equal(outs[0], outs[1])
    # the identity in eval and at p 0, with no draw
    t = _port(x, dtype)
    assert F.dropout(t, 0.3, training=False) is t
    assert F.dropout(t, 0.0) is t
    assert prand.get_rng_state() == (4, 1)


@pytest.mark.parametrize("name", ["dropout2d", "dropout3d",
                                  "alpha_dropout"])
def test_other_dropouts_equal_the_reference_bit_for_bit(name):
    x = _x(2, 2, 3, 4, 5, 6) if name == "dropout3d" else _x(2, 2, 3, 4, 5)
    _seed(8)
    ref = getattr(JF, name)(_jax(x), 0.25)
    ours = getattr(F, name)(_port(x), 0.25)
    np.testing.assert_array_equal(_f32(ours), _f32(ref))


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_layer_equals_the_reference(mode):
    x = _x(3, 2, 3, 4, 5)
    jl = jnn.Dropout(0.2, axis=1, mode=mode)
    pl = pnn.Dropout(0.2, axis=1, mode=mode)
    _seed(9)
    np.testing.assert_array_equal(_f32(pl(_port(x))), _f32(jl(_jax(x))))
    pl.eval()
    t = _port(x)
    assert pl(t) is t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sdpa", "sdpa_mask", "flash"])
def test_attention_dropout_matches_the_reference(kind, dtype):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
               for _ in range(3))
    mask = (np.triu(np.full((24, 24), -1e4, np.float32), 1)[None, None]
            if kind == "sdpa_mask" else None)
    _seed(21)
    jargs = [_jax(a, dtype) for a in (q, k, v)]
    pargs = [_port(a, dtype) for a in (q, k, v)]
    if kind == "flash":
        ref, _ = JF.flash_attention(*jargs, dropout=0.1, causal=True)
        ours, _ = F.flash_attention(*pargs, dropout=0.1, causal=True)
    else:
        ref = JF.scaled_dot_product_attention(
            *jargs, attn_mask=None if mask is None else P.to_tensor(mask),
            dropout_p=0.1, is_causal=mask is None)
        ours = F.scaled_dot_product_attention(
            *pargs, attn_mask=None if mask is None else torch.as_tensor(mask),
            dropout_p=0.1, is_causal=mask is None)
    r = _f32(ref)
    tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(r).max()
    np.testing.assert_allclose(_f32(ours), r, rtol=0, atol=tol)
    assert prand.get_rng_state() == (21, 1)


def test_recompute_draws_the_forward_masks_again():
    """Dropout inside a checkpointed segment, in a step's context and
    outside one: the recomputation replays the forward's keys, so the
    gradients equal the plain run's bit for bit."""
    from torch.utils.checkpoint import checkpoint

    from paddle_tpu_torch.jit import trace_state

    w0 = torch.as_tensor(_x(4, 32, 32))

    def seg(x, w):
        return F.dropout(torch.tanh(x @ w), 0.4) @ w

    def grads(recompute, in_step):
        w = w0.clone().requires_grad_()
        x = torch.as_tensor(_x(5, 8, 32))
        prand.seed(13)
        ctx = (trace_state.TraceContext(prand.key(77)) if in_step
               else None)
        with trace_state.activate(ctx):
            y = (checkpoint(seg, x, w, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=_recompute_contexts)
                 if recompute else seg(x, w))
        y.square().sum().backward()
        return w.grad, prand.get_rng_state()

    for in_step in (False, True):
        (ga, sa), (gb, sb) = grads(True, in_step), grads(False, in_step)
        assert torch.equal(ga, gb)
        assert sa == sb


# --------------------------------------------------------------- 2-layer BERT
VOCAB, H, HEADS, SEQ, BATCH, LAYERS = 128, 32, 4, 16, 4, 2


class _JaxBert(jnn.Layer):
    """bench_ladder.py's BertClassifier at narrow width."""

    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(VOCAB, H)
        self.pos = jnn.Embedding(SEQ, H)
        self.encoder = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(
            H, HEADS, 4 * H, dropout=0.1, activation="gelu"), LAYERS)
        self.cls = jnn.Linear(H, 2)

    def forward(self, ids):
        x = self.embed(ids) + self.pos(P.arange(SEQ).astype("int32"))
        return self.cls(self.encoder(x)[:, 0])


class _PortBert(torch.nn.Module):
    def __init__(self):
        super().__init__()
        kw = dict(device="cpu", generator=torch.Generator())
        self.embed = pnn.Embedding(VOCAB, H, **kw)
        self.pos = pnn.Embedding(SEQ, H, **kw)
        self.encoder = TransformerEncoder(TransformerEncoderLayer(
            H, HEADS, 4 * H, dropout=0.1, activation="gelu", **kw), LAYERS)
        self.cls = pnn.Linear(H, 2, **kw)

    def forward(self, ids):
        x = self.embed(ids) + self.pos(torch.arange(SEQ))
        return self.cls(self.encoder(x)[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_train_steps_with_dropout_match_the_reference(dtype):
    lr, steps = 1e-3, 3
    P.seed(0)
    jm = _JaxBert()
    pm = _PortBert()
    pnn.load_numpy_state_dict(pm, {k: np.asarray(v._value)
                                   for k, v in jm.state_dict().items()})
    mp = dtype == "bfloat16"
    if mp:
        jm.bfloat16()
        pm.bfloat16()
    w0 = {k: _f32(v) for k, v in jm.named_parameters()}
    jopt = P.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters(),
                             multi_precision=mp)
    popt = AdamW(learning_rate=lr, parameters=pm.parameters(),
                 multi_precision=mp)
    jstep = P.jit.TrainStep(jm, lambda m, i, y: JF.cross_entropy(m(i), y),
                            jopt)
    pstep = TrainStep(pm, lambda m, i, y: F.cross_entropy(m(i), y), popt)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    y = rng.integers(0, 2, (BATCH,)).astype(np.int64)
    _seed(100)
    jl = [float(_f32(jstep(P.to_tensor(ids), P.to_tensor(y))))
          for _ in range(steps)]
    pl = [float(pstep(torch.as_tensor(ids), torch.as_tensor(y)))
          for _ in range(steps)]
    assert prand.get_rng_state() == (100, steps)
    drift = 2 * lr * steps
    np.testing.assert_allclose(pl, jl, rtol=1e-5 if not mp else 2e-2)
    for k, v in pm.state_dict().items():
        ref = _f32(jm.state_dict()[k])
        err = np.abs(_f32(v) - ref)
        scale = float(np.abs(ref).max())
        tol = (1e-4 if not mp else 2 ** -7) * scale
        assert float(err.max()) <= tol + drift, k
        # k_proj's bias has a gradient of 0 in exact arithmetic (the
        # softmax over keys ignores a shift shared by all keys): Adam steps
        # on its rounding noise, whose sign differs between the packages
        if not mp and not k.endswith("k_proj.bias"):
            assert float(np.mean(err > tol)) <= 1e-3, k
        if mp and ref.ndim == 2:
            assert float(np.mean(err > tol)) <= 1e-2, k
    for (name, a), (pname, b) in zip(jm.named_parameters(),
                                     pm.named_parameters()):
        assert name == pname
        if name.endswith("k_proj.bias"):
            continue
        for acc in ("beta_pow", "moment1", "moment2"):
            ref = _f32(jopt._accumulators[acc][id(a)])
            got = _f32(popt._accumulators[acc][id(b)])
            if acc == "beta_pow":
                assert np.array_equal(got, ref), name
                continue
            assert (np.linalg.norm(got - ref)
                    <= (1e-4 if not mp else 0.15) * np.linalg.norm(ref)), \
                (name, acc)
        ref = _f32(jopt._master_weights.get(id(a), a._value)) - w0[name]
        got = _f32(popt._master_weights.get(id(b), b)) - w0[name]
        assert np.linalg.norm(ref) > 0, name
        assert (np.linalg.norm(got - ref)
                <= (1e-3 if not mp else 0.3) * np.linalg.norm(ref)), name
    # the same seed draws the same masks again; another seed others
    again = []
    for s in (100, 100, 101):
        _seed(s)
        pm.train()
        with torch.no_grad():
            again.append(pm(torch.as_tensor(ids)).float())
    assert torch.equal(again[0], again[1])
    assert not torch.equal(again[0], again[2])
