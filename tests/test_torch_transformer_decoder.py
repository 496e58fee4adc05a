"""The port's Transformer decoder (``paddle_tpu_torch/nn/transformer.py``:
``TransformerDecoderLayer``, ``TransformerDecoder``, ``Transformer``) and
the layer options it brought (``LayerNorm(weight_attr=False,
bias_attr=False)``, ``MultiHeadAttention(need_weights, weight_attr)``)
against the JAX package's ``paddle_tpu/nn/layer/transformer.py``, on the
CPU at d_model 64, 4 heads, FFN 128, 2 layers.

Weights are drawn from a numpy seed, set on the reference layer and
carried to the port by ``load_numpy_state_dict``; inputs come from a
numpy seed.  The port's unmasked attention runs kernel B1's plain version
(the encoder, the cross-attention without a memory mask, and every cached
step: one query over the growing ``Cache`` or the ``StaticCache``), a
masked one the plain masked attention, as the reference.

Tolerances (float32): 1e-5 of the largest |value| (XLA and PyTorch sum
in different orders).  A cached decode equals the teacher-forced forward
under ``generate_square_subsequent_mask`` row by row to the same 1e-5
(the -1e9 of the mask gives an exact 0 in the softmax).  Training with
dropout 0.1: the same seed draws the same masks on both sides, so the
outputs while training and three ``TrainStep``s' losses agree to 1e-5
relative and every parameter to 1e-4 of its tensor's largest |w| for all
but 1e-3 of its elements, within 2 lr steps a step everywhere (Adam's
sign of a near-zero gradient may differ; the k projections' biases have a
gradient of 0 in exact arithmetic).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.base.param_attr import ParamAttr
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.initializer import Constant
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.framework import random as prand
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import load_numpy_state_dict
from paddle_tpu_torch.nn.transformer import (
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

D, HEADS, FFN, LAYERS = 64, 4, 128, 2
B, T, S = 2, 6, 5


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return dict(device="cpu", generator=g)


def _carry(jax_layer, port_layer, seed=0):
    """Random numpy values for every reference parameter, set on the
    reference layer and loaded into the port; both in eval."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in jax_layer.state_dict().items():
        a = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = a * (0.1 if k.endswith("bias") else 1.0 / np.sqrt(a.shape[0]))
        if "norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * a
    assert list(port_layer.state_dict()) == list(sd)
    missing, unexpected = jax_layer.set_state_dict(sd)
    assert not missing and not unexpected
    load_numpy_state_dict(port_layer, sd)
    jax_layer.eval()
    port_layer.eval()
    return sd


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _j(a):
    return None if a is None else P.to_tensor(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(ours, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(ours, np.float32) - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + rel, err


def _causal(n):
    return Transformer.generate_square_subsequent_mask(n, device="cpu")


def _memory_mask(seed):
    m = np.where(np.random.default_rng(seed).random((B, 1, T, S)) < 0.3,
                 -1e9, 0.0).astype(np.float32)
    m[..., 0] = 0.0                         # every row sees a key
    return m


def _decoder_pair(normalize_before=False, activation="relu", dropout=0.0,
                  norm=False):
    jl = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
        D, HEADS, FFN, dropout, activation,
        normalize_before=normalize_before), LAYERS,
        jnn.LayerNorm(D) if norm else None)
    pl = TransformerDecoder(TransformerDecoderLayer(
        D, HEADS, FFN, dropout, activation,
        normalize_before=normalize_before, **_gen()), LAYERS,
        pnn.LayerNorm(D, device="cpu") if norm else None)
    _carry(jl, pl)
    return jl, pl


def test_square_subsequent_mask_equals_the_reference():
    ref = jnn.Transformer.generate_square_subsequent_mask(7).numpy()
    ours = _causal(7)
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches(normalize_before, activation):
    jl = jnn.TransformerDecoderLayer(D, HEADS, FFN, 0.1, activation,
                                     normalize_before=normalize_before)
    pl = TransformerDecoderLayer(D, HEADS, FFN, 0.1, activation,
                                 normalize_before=normalize_before, **_gen())
    _carry(jl, pl)
    tgt, mem = _x(1, B, T, D), _x(2, B, S, D)
    tm, mm = _causal(T).numpy(), _memory_mask(3)
    for masks in ((None, None), (tm, None), (tm, mm)):
        ref = jl(_j(tgt), _j(mem), *map(_j, masks)).numpy()
        with torch.no_grad():
            ours = pl(_t(tgt), _t(mem), *map(_t, masks)).numpy()
        _close(ours, ref)


@pytest.mark.parametrize("do_zip", [False, True])
def test_gen_cache_and_cached_decode(do_zip):
    """``gen_cache``'s layout, then a decode fed one target token a step
    over the caches: each step equals the reference's cached step and row
    t of the teacher-forced forward under the causal mask; the StaticCache
    comes back as it went in."""
    jd, pd = _decoder_pair(normalize_before=True, activation="gelu",
                           norm=True)
    tgt, mem = _x(4, B, T, D), _x(5, B, S, D)
    with torch.no_grad():
        caches = pd.gen_cache(_t(mem), do_zip=do_zip)
    jcaches = jd.gen_cache(_j(mem), do_zip=do_zip)
    if do_zip:
        assert len(caches) == 2 and len(caches[0]) == LAYERS
        assert all(isinstance(c, MultiHeadAttention.Cache)
                   for c in caches[0])
        assert all(isinstance(c, MultiHeadAttention.StaticCache)
                   for c in caches[1])
        for pc, jc in zip(caches[1], jcaches[1]):
            _close(pc.k.numpy(), jc.k.numpy())
            _close(pc.v.numpy(), jc.v.numpy())
        return
    assert len(caches) == LAYERS
    for (inc, static), (jinc, jstatic) in zip(caches, jcaches):
        assert tuple(inc.k.shape) == (B, 0, HEADS, D // HEADS)
        assert tuple(static.k.shape) == (B, S, HEADS, D // HEADS)
        _close(static.v.numpy(), jstatic.v.numpy())
    with torch.no_grad():
        full = pd(_t(tgt), _t(mem), _causal(T)).numpy()
    np.testing.assert_allclose(
        full, jd(_j(tgt), _j(mem), _j(_causal(T).numpy())).numpy(),
        rtol=0, atol=1e-5 * np.abs(full).max() + 1e-5)
    for t in range(T):
        step = tgt[:, t:t + 1]
        jout, jcaches = jd(_j(step), _j(mem), None, None, jcaches)
        with torch.no_grad():
            out, new = pd(_t(step), _t(mem), None, None, caches)
        for (inc, static), (old_inc, old_static) in zip(new, caches):
            assert static is old_static
            assert inc.k.shape[1] == t + 1
        caches = new
        _close(out.numpy(), jout.numpy())
        _close(out.numpy()[:, 0], full[:, t])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_end_to_end(normalize_before):
    jt = jnn.Transformer(D, HEADS, LAYERS, LAYERS, FFN, dropout=0.1,
                         normalize_before=normalize_before)
    pt = Transformer(D, HEADS, LAYERS, LAYERS, FFN, dropout=0.1,
                     normalize_before=normalize_before, **_gen())
    _carry(jt, pt)
    assert (pt.encoder.norm is None) == (pt.decoder.norm is None) \
        == (not normalize_before)
    src, tgt = _x(6, B, S, D), _x(7, B, T, D)
    src_mask = np.zeros((B, 1, S, S), np.float32)
    src_mask[0, ..., -1] = -1e9            # row 0's last source is padding
    args = (src, tgt, src_mask, _causal(T).numpy(), _memory_mask(8))
    ref = jt(*map(_j, args)).numpy()
    with torch.no_grad():
        ours = pt(*map(_t, args)).numpy()
    _close(ours, ref)


def test_transformer_with_custom_encoder_and_decoder():
    enc = TransformerEncoder(TransformerEncoderLayer(D, HEADS, FFN, 0.0,
                                                     **_gen()), 1)
    dec = TransformerDecoder(TransformerDecoderLayer(D, HEADS, FFN, 0.0,
                                                     **_gen(1)), 1)
    pt = Transformer(D, HEADS, custom_encoder=enc, custom_decoder=dec,
                     **_gen())
    assert pt.encoder is enc and pt.decoder is dec
    jt = jnn.Transformer(D, HEADS, custom_encoder=jnn.TransformerEncoder(
        jnn.TransformerEncoderLayer(D, HEADS, FFN, 0.0), 1),
        custom_decoder=jnn.TransformerDecoder(jnn.TransformerDecoderLayer(
            D, HEADS, FFN, 0.0), 1))
    _carry(jt, pt)
    src, tgt = _x(9, B, S, D), _x(10, B, T, D)
    with torch.no_grad():
        ours = pt(_t(src), _t(tgt), None, _causal(T)).numpy()
    _close(ours, jt(_j(src), _j(tgt), None,
                    _j(_causal(T).numpy())).numpy())


def test_decoder_layers_start_from_the_same_weights():
    dec = TransformerDecoder(TransformerDecoderLayer(D, HEADS, FFN,
                                                     **_gen()), 3)
    first = dec.layers[0].state_dict()
    for layer in dec.layers[1:]:
        for k, v in layer.state_dict().items():
            assert torch.equal(v, first[k])
            assert v.data_ptr() != first[k].data_ptr()


class _JaxSeq2Seq(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.t = jnn.Transformer(D, HEADS, LAYERS, LAYERS, FFN, dropout=0.1)

    def forward(self, src, tgt, mask):
        return self.t(src, tgt, None, mask)


class _PortSeq2Seq(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.t = Transformer(D, HEADS, LAYERS, LAYERS, FFN, dropout=0.1,
                             **_gen())

    def forward(self, src, tgt, mask):
        return self.t(src, tgt, None, mask)


def test_training_with_dropout_matches_the_reference():
    """Dropout 0.1 in every place the decoder has one (self-attention's,
    dropout1, cross-attention's, dropout2, act_dropout, dropout3): the
    same seed gives the same masks, so the outputs while training equal
    the reference's, and three TrainSteps of AdamW keep the losses and
    weights together."""
    lr, steps = 1e-3, 3
    jm, pm = _JaxSeq2Seq(), _PortSeq2Seq()
    _carry(jm, pm)
    jm.train()
    pm.train()
    src, tgt = _x(11, B, S, D), _x(12, B, T, D)
    mask = _causal(T)
    P.seed(21)
    prand.seed(21)
    ref = jm(_j(src), _j(tgt), _j(mask.numpy())).numpy()
    ours = pm(_t(src), _t(tgt), mask).detach().numpy()
    _close(ours, ref)
    # decoder 2 x (2 attention masks + 4 dropouts), encoder 2 x (1 + 3)
    assert prand.get_rng_state() == (21, 20)
    P.seed(22)
    prand.seed(22)
    again = pm(_t(src), _t(tgt), mask).detach().numpy()
    assert np.abs(again - ours).max() > 1e-3        # other masks
    y = np.random.default_rng(13).integers(0, D, (B * T,)).astype(np.int64)
    jopt = P.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters())
    popt = AdamW(learning_rate=lr, parameters=pm.parameters())
    jstep = P.jit.TrainStep(jm, lambda m, s, t, k, yy: JF.cross_entropy(
        m(s, t, k).reshape([-1, D]), yy), jopt)
    pstep = TrainStep(pm, lambda m, s, t, k, yy: F.cross_entropy(
        m(s, t, k).reshape(-1, D), yy), popt)
    P.seed(100)
    prand.seed(100)
    jl = [float(jstep(_j(src), _j(tgt), _j(mask.numpy()), _j(y)).numpy())
          for _ in range(steps)]
    pl = [float(pstep(_t(src), _t(tgt), mask, _t(y)))
          for _ in range(steps)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert pl[-1] < pl[0]
    for k, v in pm.state_dict().items():
        ref = jm.state_dict()[k].numpy()
        err = np.abs(v.numpy() - ref)
        tol = 1e-4 * float(np.abs(ref).max())
        assert float(err.max()) <= tol + 2 * lr * steps, k
        if not k.endswith("k_proj.bias"):
            assert float(np.mean(err > tol)) <= 1e-3, k


@pytest.mark.parametrize("weight,bias", [(False, False), (None, False),
                                         (False, None)])
def test_layer_norm_without_weight_or_bias(weight, bias):
    """The parameter set to False is left out.  Without a weight but with
    a bias the port adds the bias, paddle's rule; the reference's
    functional takes its first parameter as the weight (``F.layer_norm``,
    ``nn/functional/norm.py:98-103``) and multiplies by the bias, so that
    case is held to the formula."""
    jl = jnn.LayerNorm(D, weight_attr=weight, bias_attr=bias)
    pl = pnn.LayerNorm(D, weight_attr=weight, bias_attr=bias, device="cpu")
    assert list(pl.state_dict()) == list(jl.state_dict())
    assert (pl.weight is None) == (weight is False)
    assert (pl.bias is None) == (bias is False)
    if jl.state_dict():
        _carry(jl, pl)
    x = _x(14, B, T, D)
    with torch.no_grad():
        ours = pl(_t(x)).numpy()
    if weight is False and bias is not False:
        norm = (x - x.mean(-1, keepdims=True)) / np.sqrt(
            x.var(-1, keepdims=True) + 1e-5)
        _close(ours, norm + pl.bias.detach().numpy())
    else:
        _close(ours, jl(_j(x)).numpy())


def test_layer_norm_of_another_dtype_promotes_as_the_reference():
    """A bfloat16 input with float32 parameters: normalized in bfloat16,
    then scaled in float32, as the reference's jnp formula."""
    jl, pl = jnn.LayerNorm(D), pnn.LayerNorm(D, device="cpu")
    _carry(jl, pl)
    x = _x(15, B, T, D)
    ref = jl(P.to_tensor(x).astype("bfloat16"))
    with torch.no_grad():
        ours = pl(_t(x).bfloat16())
    assert ours.dtype == torch.float32
    assert ref._value.dtype.name == "float32"
    _close(ours.numpy(), ref.numpy(), 2e-2)


def test_multi_head_attention_need_weights_and_weight_attr():
    jm = jnn.MultiHeadAttention(D, HEADS, need_weights=True,
                                weight_attr=ParamAttr(name="w"))
    pm = MultiHeadAttention(D, HEADS, need_weights=True,
                            weight_attr=ParamAttr(name="w"), **_gen())
    assert pm.need_weights is True
    _carry(jm, pm)
    q, kv = _x(16, B, T, D), _x(17, B, S, D)
    with torch.no_grad():
        ours = pm(_t(q), _t(kv), _t(kv))
    assert isinstance(ours, torch.Tensor)   # no weights come back
    _close(ours.numpy(), jm(_j(q), _j(kv), _j(kv)).numpy())
    for attr in (ParamAttr(initializer=Constant(0.5)), Constant(0.5)):
        with pytest.raises(NotImplementedError, match="A10"):
            MultiHeadAttention(D, HEADS, weight_attr=attr, **_gen())
    with pytest.raises(NotImplementedError, match="A10"):
        pnn.Linear(D, D, bias_attr=ParamAttr(initializer=Constant(0.0)),
                   **_gen())
    with pytest.raises(NotImplementedError, match="frozen"):
        TransformerDecoderLayer(D, HEADS, FFN, weight_attr=ParamAttr(
            trainable=False), **_gen())


def test_cached_decode_under_o2_keeps_the_reference_cache_dtype():
    """C15 for ``MultiHeadAttention.Cache``: under O2 the float32 memory's
    empty Cache grows through the reference's "concat", cast to bfloat16,
    so the step's new Cache is bfloat16 (torch.cat gave float32)."""
    from paddle_tpu_torch import amp as pamp

    jd, pd = _decoder_pair()
    P.amp.decorate(models=jd, level="O2", dtype="bfloat16")
    pamp.decorate(models=pd, level="O2", dtype="bfloat16")
    tgt, mem = _x(18, B, T, D), _x(19, B, S, D)
    jc = jd.gen_cache(_j(mem))
    with torch.no_grad():
        pc = pd.gen_cache(_t(mem))
    with P.amp.auto_cast(level="O2", dtype="bfloat16"):
        jo, jc = jd(_j(tgt[:, :1]), _j(mem), None, None, jc)
    with torch.no_grad(), pamp.auto_cast(level="O2", dtype="bfloat16"):
        po, pc = pd(_t(tgt[:, :1]), _t(mem), None, None, pc)
    _close(po.float().numpy(), jo.astype("float32").numpy(), 2e-2)
    for (inc, _), (jinc, _) in zip(pc, jc):
        assert jinc.k._value.dtype.name == "bfloat16"
        assert inc.k.dtype == inc.v.dtype == torch.bfloat16
        _close(inc.k.float().numpy(), jinc.k.astype("float32").numpy(),
               2e-2)
