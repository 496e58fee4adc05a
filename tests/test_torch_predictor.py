"""The port's inference predictor and the layers it serves, against the JAX
package on the CPU: ``Linear`` with a bias, ``LayerNorm``, ``gelu``,
``MultiHeadAttention`` (no mask, an additive mask, ``Cache``,
``StaticCache``), ``TransformerEncoderLayer``, ``TransformerEncoder``, and
bench_ladder.py's BERT classifier (here 2 layers, hidden 64, 4 heads,
seq 16) through float and weight-only int8 ``Predictor``s.

Weights are drawn from a numpy seed, set on the reference layer and carried
to the port by ``load_numpy_state_dict`` (the reference's ``state_dict``
names equal the port's); inputs come from a numpy seed.  Reference layers
run in eval, its attention through ``_ref_attention`` (the CPU path), the
port's unmasked attention through kernel B1's plain version.

Tolerances (float32): layers and the float predictor 1e-5 (summation order
between XLA and PyTorch); the int8 predictor 1e-4 of the largest |logit|:
the reference's int8 path on the CPU is its fallback, which scales the
weight before the product, the port's (B7's plain version) after it, and
the rounding difference passes through two layers.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import inference as jinf
from paddle_tpu import nn as jnn
from paddle_tpu.inference import _pad_batch as jax_pad_batch
from paddle_tpu.inference import _rewrite_weight_only_int8 as jax_rewrite
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import inference as pinf
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import load_numpy_state_dict
from paddle_tpu_torch.nn.transformer import (
    MultiHeadAttention,
    TransformerEncoder,
    TransformerEncoderLayer,
)
from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, H, LAYERS, HEADS, SEQ = 512, 64, 2, 4, 16


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return dict(device="cpu", generator=g)


def _carry(jax_layer, port_layer, seed=0):
    """Random numpy values for every reference parameter (biases and norm
    weights too), set on the reference layer and loaded into the port."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in jax_layer.state_dict().items():
        a = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        sd[k] = a * (0.1 if k.endswith("bias") else 1.0 / np.sqrt(a.shape[0]))
        if "norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * a
    missing, unexpected = jax_layer.set_state_dict(sd)
    assert not missing and not unexpected
    load_numpy_state_dict(port_layer, sd)
    jax_layer.eval()
    port_layer.eval()
    return sd


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _run_jax(layer, *args):
    out = layer(*[None if a is None else P.to_tensor(a) for a in args])
    return out


def _run_port(layer, *args):
    with torch.no_grad():
        return layer(*[None if a is None else torch.from_numpy(a)
                       for a in args])


# ------------------------------------------------------------------ layers
def test_linear_with_bias_and_without():
    x = _x(1, 3, 5, 16)
    jl, pl = jnn.Linear(16, 8), pnn.Linear(16, 8, **_gen())
    _carry(jl, pl)
    assert set(pl.state_dict()) == {"weight", "bias"}
    np.testing.assert_allclose(_run_port(pl, x).numpy(),
                               _run_jax(jl, x).numpy(), **TOL)
    jl, pl = (jnn.Linear(16, 8, bias_attr=False),
              pnn.Linear(16, 8, bias_attr=False, **_gen()))
    _carry(jl, pl)
    assert pl.bias is None and set(pl.state_dict()) == {"weight"}
    np.testing.assert_allclose(_run_port(pl, x).numpy(),
                               _run_jax(jl, x).numpy(), **TOL)


def test_linear_bias_starts_at_zero():
    assert not pnn.Linear(4, 3, **_gen()).bias.detach().any()


def test_layer_norm_matches():
    x = _x(2, 4, 6, 32) * 3 + 1
    jl, pl = jnn.LayerNorm(32, epsilon=1e-5), pnn.LayerNorm(32, device="cpu")
    _carry(jl, pl)
    np.testing.assert_allclose(_run_port(pl, x).numpy(),
                               _run_jax(jl, x).numpy(), **TOL)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_exact_and_tanh(approximate):
    x = _x(3, 257) * 4
    ref = P.nn.functional.gelu(P.to_tensor(x), approximate=approximate)
    ours = F.gelu(torch.from_numpy(x), approximate=approximate)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), **TOL)
    np.testing.assert_array_equal(
        F.relu(torch.from_numpy(x)).numpy(),
        P.nn.functional.relu(P.to_tensor(x)).numpy())


def test_dropout_is_identity_in_eval_and_raises_while_training():
    """The identity in eval and at p 0; while training (refused before the
    port had a random stream) the reference's Dropout bit for bit from the
    same seed."""
    from paddle_tpu_torch.framework import random as prand

    d = pnn.Dropout(0.1)
    x = torch.ones(3)
    d.eval()
    assert d(x) is x
    assert pnn.Dropout(0.0)(x) is x
    d.train()
    xs = np.random.default_rng(4).standard_normal((4, 33)).astype(
        np.float32)
    P.seed(5)
    prand.seed(5)
    ref = jnn.Dropout(0.1)(P.to_tensor(xs)).numpy()
    ours = d(torch.as_tensor(xs)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert 0 < int((ours == 0).sum()) < ours.size


def _mha_pair():
    jm, pm = jnn.MultiHeadAttention(H, HEADS), MultiHeadAttention(
        H, HEADS, **_gen())
    _carry(jm, pm)
    return jm, pm


def test_multi_head_attention_unmasked_and_additive_mask():
    jm, pm = _mha_pair()
    q, kv = _x(4, 2, 5, H), _x(5, 2, 7, H)
    np.testing.assert_allclose(_run_port(pm, q, kv, kv).numpy(),
                               _run_jax(jm, q, kv, kv).numpy(), **TOL)
    mask = np.where(np.random.default_rng(6).random((2, 1, 5, 7)) < 0.3,
                    -1e9, 0.0).astype(np.float32)
    mask[..., 0] = 0.0                     # every row sees a key
    np.testing.assert_allclose(_run_port(pm, q, kv, kv, mask).numpy(),
                               _run_jax(jm, q, kv, kv, mask).numpy(), **TOL)


def test_multi_head_attention_growing_cache():
    jm, pm = _mha_pair()
    x1, x2 = _x(7, 2, 3, H), _x(8, 2, 1, H)
    jc = jm.gen_cache(P.to_tensor(x1))
    pc = pm.gen_cache(torch.from_numpy(x1))
    assert isinstance(pc, MultiHeadAttention.Cache)
    assert tuple(pc.k.shape) == (2, 0, HEADS, H // HEADS)
    for x in (x1, x2):
        jo, jc = jm(P.to_tensor(x), None, None, None, jc)
        with torch.no_grad():
            po, pc = pm(torch.from_numpy(x), None, None, None, pc)
        np.testing.assert_allclose(po.numpy(), jo.numpy(), **TOL)
    assert tuple(pc.k.shape) == (2, 4, HEADS, H // HEADS)
    np.testing.assert_allclose(pc.k.numpy(), jc.k.numpy(), **TOL)
    np.testing.assert_allclose(pc.v.numpy(), jc.v.numpy(), **TOL)


def test_multi_head_attention_static_cache():
    jm, pm = _mha_pair()
    q, mem = _x(9, 2, 4, H), _x(10, 2, 6, H)
    jc = jm.gen_cache(P.to_tensor(mem), P.to_tensor(mem),
                      jnn.MultiHeadAttention.StaticCache)
    with torch.no_grad():
        pc = pm.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                          MultiHeadAttention.StaticCache)
        po = pm(torch.from_numpy(q), None, None, None, pc)
    jo = jm(P.to_tensor(q), None, None, None, jc)
    assert isinstance(po, torch.Tensor)
    np.testing.assert_allclose(pc.k.numpy(), jc.k.numpy(), **TOL)
    np.testing.assert_allclose(po.numpy(), jo.numpy(), **TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_encoder_layer(normalize_before, activation):
    jl = jnn.TransformerEncoderLayer(H, HEADS, 4 * H, dropout=0.1,
                                     activation=activation,
                                     normalize_before=normalize_before)
    pl = TransformerEncoderLayer(H, HEADS, 4 * H, dropout=0.1,
                                 activation=activation,
                                 normalize_before=normalize_before, **_gen())
    _carry(jl, pl)
    assert list(pl.state_dict()) == list(jl.state_dict())
    x = _x(11, 2, 6, H)
    np.testing.assert_allclose(_run_port(pl, x).numpy(),
                               _run_jax(jl, x).numpy(), **TOL)


def test_transformer_encoder_with_final_norm():
    jl = jnn.TransformerEncoder(
        jnn.TransformerEncoderLayer(H, HEADS, 4 * H, activation="gelu",
                                    normalize_before=True), 2,
        jnn.LayerNorm(H))
    pl = TransformerEncoder(
        TransformerEncoderLayer(H, HEADS, 4 * H, activation="gelu",
                                normalize_before=True, **_gen()), 2,
        pnn.LayerNorm(H, device="cpu"))
    _carry(jl, pl)
    x = _x(12, 2, 6, H)
    np.testing.assert_allclose(_run_port(pl, x).numpy(),
                               _run_jax(jl, x).numpy(), **TOL)


# ---------------------------------------------------- the BERT classifier
class JaxBert(jnn.Layer):
    """bench_ladder.py's BertClassifier at the test's sizes."""

    def __init__(self):
        super().__init__()
        self.embed = jnn.Embedding(VOCAB, H)
        self.pos = jnn.Embedding(SEQ, H)
        self.encoder = jnn.TransformerEncoder(
            jnn.TransformerEncoderLayer(H, HEADS, 4 * H, dropout=0.1,
                                        activation="gelu"), LAYERS)
        self.cls = jnn.Linear(H, 2)

    def forward(self, ids):
        x = self.embed(ids) + self.pos(P.arange(SEQ).astype("int32"))
        return self.cls(self.encoder(x)[:, 0])


class PortBert(torch.nn.Module):
    """The same classifier from the port's layers."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        kw = dict(dtype=dtype, **_gen(1))
        self.embed = pnn.Embedding(VOCAB, H, **kw)
        self.pos = pnn.Embedding(SEQ, H, **kw)
        self.encoder = TransformerEncoder(
            TransformerEncoderLayer(H, HEADS, 4 * H, dropout=0.1,
                                    activation="gelu", **kw), LAYERS)
        self.cls = pnn.Linear(H, 2, **kw)

    def forward(self, ids):
        pos = torch.arange(SEQ, device=ids.device)
        x = self.embed(ids) + self.pos(pos)
        return self.cls(self.encoder(x)[:, 0])


@pytest.fixture(scope="module")
def bert_pair():
    jm, pm = JaxBert(), PortBert()
    _carry(jm, pm, seed=3)
    return jm, pm


def _ids(seed=0, batch=2):
    return np.random.default_rng(seed).integers(
        0, VOCAB, (batch, SEQ)).astype(np.int32)


def _config(layer, int8=False, mod=pinf):
    cfg = mod.Config()
    cfg.set_layer(layer)
    if int8:
        cfg.enable_weight_only_quant("int8")
    return cfg


@pytest.mark.parametrize("int8", [False, True])
def test_classifier_predictor_matches_jax(bert_pair, int8):
    jm, pm = bert_pair
    ids = _ids()
    ref = jinf.create_predictor(_config(jm, int8, jinf)).run([ids])
    before = int8_matmul.launches
    ours = pinf.create_predictor(_config(pm, int8)).run([ids])
    assert int8_matmul.launches == before       # plain versions on the CPU
    assert len(ours) == 1 and ours[0].shape == (2, 2)
    assert ours[0].dtype == np.float32
    tol = (1e-4 if int8 else 1e-5) * np.abs(ref[0]).max()
    np.testing.assert_allclose(ours[0], ref[0], rtol=0, atol=tol)
    if int8:   # the int8 weights move the logits, by less than 5%
        fl = pinf.create_predictor(_config(pm)).run([ids])[0]
        assert 0 < np.abs(ours[0] - fl).max() < 0.05 * np.abs(fl).max()


def test_int8_rewrite_swaps_the_13_linears_of_a_copy(bert_pair):
    _, pm = bert_pair
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    pred = pinf.create_predictor(_config(pm, int8=True))
    swapped = [m for m in pred._layer.modules()
               if isinstance(m, pinf.Int8Linear)]
    assert len(swapped) == 13
    assert not any(isinstance(m, pnn.Linear) for m in pred._layer.modules())
    cls = pred._layer.cls
    assert cls.qweight.dtype == torch.int8 and cls.scale.dtype == torch.float32
    assert set(dict(cls.named_buffers())) == {"qweight", "scale"}
    np.testing.assert_array_equal(cls.bias.detach().numpy(),
                                  pm.cls.bias.detach().numpy())
    # the caller's layer is untouched
    assert sum(isinstance(m, pnn.Linear) for m in pm.modules()) == 13
    assert not any(isinstance(m, pinf.Int8Linear) for m in pm.modules())
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k])


def test_int8_rewrite_leaves_llama_as_the_reference_does():
    """Llama's projections are mp layers in the reference and
    ParallelLinear in the port: neither rewrite touches them."""
    jl = jax_rewrite(JaxLlama(jax_llama_tiny()))
    assert not [s for s in jl.sublayers()
                if type(s).__name__ == "Int8Linear"]
    pm = LlamaForCausalLM(llama_tiny(), device="cpu")
    pred = pinf.create_predictor(_config(pm, int8=True))
    assert not any(isinstance(m, pinf.Int8Linear)
                   for m in pred._layer.modules())
    ids = np.array([[3, 17, 101, 7]], np.int32)
    with torch.no_grad():
        want = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(pred.run([ids])[0], want)


def test_handles_api_and_pool(bert_pair):
    _, pm = bert_pair
    ids = _ids(5)
    pool = pinf.PredictorPool(_config(pm, int8=True), size=2)
    p0, p1 = pool.retrieve(0), pool.retrieve(1)
    assert p0 is not p1
    h = p0.get_input_handle("ids")
    h.reshape(ids.shape)
    h.copy_from_cpu(ids)
    assert p0.get_input_names() == ["ids"]
    p0.run()
    assert p0.get_output_names() == ["out0"]
    got = p0.get_output_handle("out0").copy_to_cpu()
    np.testing.assert_array_equal(got, p1.run([ids])[0])
    # the reference's handles API gives the same names
    jp = jinf.create_predictor(_config(bert_pair[0], mod=jinf))
    jp.get_input_handle("ids").copy_from_cpu(ids)
    jp.run()
    assert jp.get_output_names() == p0.get_output_names()


def test_refusals():
    # a missing artifact: the reference's FileNotFoundError on its meta
    with pytest.raises(FileNotFoundError, match="pdmodel.json"):
        pinf.create_predictor(pinf.Config("model.jaxexport"))
    with pytest.raises(NotImplementedError, match="int8"):
        pinf.Config().enable_weight_only_quant("int4")
    with pytest.raises(ValueError, match="set_layer"):
        pinf.create_predictor(pinf.Config())
    cfg = pinf.Config()
    for toggle in (cfg.enable_memory_optim, cfg.switch_ir_optim,
                   cfg.disable_glog_info, cfg.enable_use_gpu,
                   cfg.enable_xpu, cfg.enable_batch_padding):
        toggle()
    cfg.set_cpu_math_library_num_threads(2)


def test_bfloat16_outputs_come_back_as_float32():
    pm = PortBert(dtype=torch.bfloat16)
    ids = _ids(6)
    with torch.no_grad():
        want = pm.eval()(torch.from_numpy(ids))
    assert want.dtype == torch.bfloat16
    for int8 in (False, True):
        out = pinf.create_predictor(_config(pm, int8)).run([ids])[0]
        assert out.dtype == np.float32 and out.shape == (2, 2)
        assert np.isfinite(out).all()
    out = pinf.create_predictor(_config(pm)).run([ids])[0]
    np.testing.assert_array_equal(out, want.float().numpy())


def test_pad_batch_matches_the_reference():
    spec = [{"shape": [4, 3]}, {"shape": [None, 2]}]
    a, b = _x(13, 2, 3), _x(14, 1, 2)
    ref, rn = jax_pad_batch([P.to_tensor(a)._value, P.to_tensor(b)._value],
                            spec)
    ours, n = pinf.predictor._pad_batch(
        [torch.from_numpy(a), torch.from_numpy(b)], spec)
    assert n == rn == 2
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="exceeds"):
        pinf.predictor._pad_batch([torch.zeros(5, 3)], spec)


def test_deepcopied_encoder_layers_share_no_storage():
    layer = TransformerEncoderLayer(H, HEADS, 4 * H, **_gen())
    enc = TransformerEncoder(layer, 2)
    assert enc.layers[0] is layer
    w0, w1 = enc.layers[0].linear1.weight, enc.layers[1].linear1.weight
    assert torch.equal(w0, w1) and w0.data_ptr() != w1.data_ptr()
    assert copy.deepcopy(enc).layers[1].linear1.weight.data_ptr() != \
        w1.data_ptr()
