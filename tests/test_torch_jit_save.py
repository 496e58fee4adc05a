"""The port's ``jit.save`` / ``jit.load`` (``paddle_tpu_torch/jit/
serialization.py``) and the artifact ``Predictor`` (``inference.Config(
model_path)``) against the JAX package's on the CPU.

The same numpy weights go into a reference layer and its port twin; each
package saves its own artifact and serves it through ``Config(path)``:
the file sets (``.pt2`` in place of ``.stablehlo`` / ``.jaxexport``), the
npz and meta keys, state crossing the packages both ways (``set_onto``),
the artifact predictor's outputs (an MLP and a 2-layer hidden-64 Llama,
whose program calls the custom ops of K1, K2, K3 and B1; an int8-rewritten
MLP, B7's), batch padding and its limit, an artifact saved without
``input_spec``, the handles API and ``PredictorPool`` over an artifact,
and the graph path with a stand-in capture.  ``jit.save`` traces the
kernels' fake implementations: no plain version runs and no launch
counter moves.

Tolerances, float32: 1e-5 against the reference (summation orders); the
port's artifact against the port's live layer exactly (the same ops on
the same device); int8 against the reference 1e-4 of the largest output
(the reference scales the weight before the product, B7's plain version
after it).
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import inference as jinf
from paddle_tpu import nn as jnn
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import inference as pinf
from paddle_tpu_torch import jit
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.inference.predictor import _rewrite_weight_only_int8
from paddle_tpu_torch.jit.graphs import GraphCache, module_tensors
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import load_numpy_state_dict
from paddle_tpu_torch.ops.hopper import (
    flash_attention,
    fused_norm,
    fused_ops,
    int8_matmul,
    launch_counters,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
             num_hidden_layers=2, num_attention_heads=4,
             max_position_embeddings=64)
# the kernels' plain versions, each the CPU side of a custom op
PLAIN = ((fused_norm, "_ref_rms"), (fused_norm, "_ref_rms_residual"),
         (fused_ops, "_rope_ref"), (fused_ops, "_swiglu_ref"),
         (flash_attention, "_plain_bshd"), (int8_matmul, "_int8_matmul_ref"))


class JaxMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(8, 16)
        self.fc2 = jnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(P.nn.functional.relu(self.fc1(x)))


class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator()
        self.fc1 = pnn.Linear(8, 16, device="cpu", generator=g)
        self.fc2 = pnn.Linear(16, 4, device="cpu", generator=g)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _carry(jax_layer, port_layer, seed=0):
    """Seeded numpy values for every parameter (biases too) on both."""
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(tuple(v.shape)) * 0.3).astype(np.float32)
          for k, v in jax_layer.state_dict().items()}
    jax_layer.set_state_dict(sd)
    load_numpy_state_dict(port_layer, sd)
    jax_layer.eval()
    port_layer.eval()
    return jax_layer, port_layer


@pytest.fixture(scope="module")
def mlp_pair():
    return _carry(JaxMLP(), MLP())


@pytest.fixture(scope="module")
def llama_pair():
    jm = JaxLlama(JaxLlamaConfig(**LLAMA))
    pm = LlamaForCausalLM(LlamaConfig(**LLAMA), device="cpu")
    load_numpy_state_dict(pm, {k: np.asarray(v._value)
                               for k, v in jm.state_dict().items()})
    jm.eval()
    pm.eval()
    return jm, pm


def _files(d, stem):
    return {f[len(stem):] for f in os.listdir(d) if f.startswith(stem)}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_save_writes_the_reference_files_and_keys(mlp_pair, tmp_path):
    jl, pl = mlp_pair
    P.jit.save(jl, str(tmp_path / "ref/model"),
               input_spec=[P.jit.InputSpec([1, 8], "float32")])
    jit.save(jit.to_static(pl), str(tmp_path / "port/model"),
             input_spec=[jit.InputSpec([1, 8], "float32")])
    assert _files(tmp_path / "ref", "model") == {
        ".pdiparams.npz", ".pdmodel.json", ".stablehlo", ".jaxexport"}
    assert _files(tmp_path / "port", "model") == {
        ".pdiparams.npz", ".pdmodel.json", ".pt2"}
    rz = np.load(tmp_path / "ref/model.pdiparams.npz")
    pz = np.load(tmp_path / "port/model.pdiparams.npz")
    assert sorted(rz.files) == sorted(pz.files)
    for k in rz.files:
        np.testing.assert_array_equal(pz[k], rz[k])
    rm = json.load(open(tmp_path / "ref/model.pdmodel.json"))
    pm = json.load(open(tmp_path / "port/model.pdmodel.json"))
    assert set(pm) == set(rm) | {"device"} and pm["device"] == "cpu"
    assert (pm["layer_class"], rm["layer_class"]) == ("MLP", "JaxMLP")
    for k in set(rm) - {"layer_class"}:
        assert pm[k] == rm[k], k


def test_state_crosses_the_packages(mlp_pair, tmp_path):
    jl, pl = mlp_pair
    xn = _x(1, 3, 8)
    P.jit.save(jl, str(tmp_path / "ref"))
    jit.save(pl, str(tmp_path / "port"))
    port_net = jit.load(str(tmp_path / "ref")).set_onto(MLP())
    np.testing.assert_allclose(
        port_net(torch.from_numpy(xn)).detach().numpy(),
        np.asarray(jl(P.to_tensor(xn))._value), **TOL)
    ref_net = JaxMLP()
    P.jit.load(str(tmp_path / "port")).set_onto(ref_net)
    np.testing.assert_allclose(
        np.asarray(ref_net.eval()(P.to_tensor(xn))._value),
        pl(torch.from_numpy(xn)).detach().numpy(), **TOL)
    with pytest.raises(KeyError, match="missing"):
        jit.load(str(tmp_path / "port")).set_onto(pnn.Linear(
            8, 16, device="cpu", generator=torch.Generator()))


def _counting(monkeypatch):
    calls = {}
    for mod, name in PLAIN:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("case", ["mlp", "llama", "int8"])
def test_artifact_predictor_matches_the_reference(case, mlp_pair, llama_pair,
                                                  tmp_path, monkeypatch):
    if case == "llama":
        jl, pl = llama_pair
        xs = [np.random.default_rng(2).integers(0, 256, (2, 16)).astype(
            np.int32)]
        spec = ([2, 16], "int32")
    else:
        jl, pl = mlp_pair
        xs = [_x(2, 2, 8)]
        spec = ([2, 8], "float32")
    live = pl if case != "int8" else _rewrite_weight_only_int8(pl)
    calls = _counting(monkeypatch)
    before = {k: fn.launches for k, fn in launch_counters().items()}
    jit.save(jit.to_static(live), str(tmp_path / "port"),
             input_spec=[jit.InputSpec(*spec)])
    # the export traced the kernels' fake implementations only
    assert not calls
    assert before == {k: fn.launches for k, fn in launch_counters().items()}
    pred = pinf.create_predictor(pinf.Config(str(tmp_path / "port")))
    assert pred.get_input_names() == ["x0"]
    got = pred.run(xs)[0]
    ran = dict(calls)          # the program's own calls of the kernels
    with torch.no_grad():
        want = live(*[torch.from_numpy(x) for x in xs]).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "llama":
        ops = {str(n.target) for n in pred._loaded.program.graph.nodes
               if n.op == "call_function"}
        assert {f"paddle_tpu_torch.{k}.default" for k in (
            "rms_norm", "rms_norm_residual", "rope", "swiglu",
            "flash_attention")} <= ops
        # one norm alone, four with the residual (each through _ref_rms)
        assert ran == {"_ref_rms": 5, "_ref_rms_residual": 4, "_rope_ref": 2,
                       "_swiglu_ref": 2, "_plain_bshd": 2}
    if case == "int8":
        assert ran == {"_int8_matmul_ref": 2}
        cfg = jinf.Config()
        cfg.set_layer(jl)
        cfg.enable_weight_only_quant("int8")
        ref = jinf.create_predictor(cfg).run(xs)[0]
        tol = 1e-4 * float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
        return
    P.jit.save(jl, str(tmp_path / "ref"), input_spec=[P.jit.InputSpec(*spec)])
    ref = jinf.create_predictor(jinf.Config(str(tmp_path / "ref"))).run(xs)
    np.testing.assert_allclose(got, ref[0], **TOL)


def test_batch_padding_and_its_limit(mlp_pair, tmp_path):
    jl, pl = mlp_pair
    jit.save(pl, str(tmp_path / "port"), input_spec=[
        jit.InputSpec([4, 8], "float32")])
    P.jit.save(jl, str(tmp_path / "ref"), input_spec=[
        P.jit.InputSpec([4, 8], "float32")])
    preds = []
    for inf, path in ((pinf, "port"), (jinf, "ref")):
        cfg = inf.Config(str(tmp_path / path))
        cfg.enable_batch_padding()
        preds.append(inf.create_predictor(cfg))
    xn = _x(3, 3, 8)
    got, ref = (p.run([xn])[0] for p in preds)
    assert got.shape == ref.shape == (3, 4)
    np.testing.assert_allclose(got, ref, **TOL)
    padded = np.concatenate([xn, np.zeros((1, 8), np.float32)])
    np.testing.assert_array_equal(
        got, pl(torch.from_numpy(padded)).detach().numpy()[:3])
    for p in preds:
        with pytest.raises(ValueError, match="exceeds compiled batch 4"):
            p.run([_x(4, 5, 8)])


def test_artifact_without_input_spec_raises_on_call(mlp_pair, tmp_path):
    jl, pl = mlp_pair
    jit.save(pl, str(tmp_path / "port"))
    P.jit.save(jl, str(tmp_path / "ref"))
    assert _files(tmp_path, "port") == {".pdiparams.npz", ".pdmodel.json"}
    for load, t in ((jit.load, torch.ones), (P.jit.load, P.ones)):
        with pytest.raises(RuntimeError, match="without input_spec"):
            load(str(tmp_path / ("port" if load is jit.load else "ref")))(
                t([1, 8]))
    pred = pinf.create_predictor(pinf.Config(str(tmp_path / "port")))
    assert pred.get_input_names() == []
    with pytest.raises(RuntimeError, match="without input_spec"):
        pred.run([_x(0, 1, 8)])
    with pytest.raises(FileNotFoundError, match="pdmodel.json"):
        jit.load(str(tmp_path / "missing"))


def _stub_capture(fn, pool):
    out = fn()

    class Replayed:
        replays = 0

        def replay(self):
            Replayed.replays += 1
            for o, n in zip(out, fn()):
                o.copy_(n)

    return Replayed(), out


def test_handles_pool_warning_and_graphs_over_an_artifact(mlp_pair,
                                                          tmp_path):
    _, pl = mlp_pair
    path = str(tmp_path / "model")
    jit.save(pl, path, input_spec=[jit.InputSpec([2, 8], "float32")])
    cfg = pinf.Config(path)
    cfg.enable_weight_only_quant("int8")
    with pytest.warns(UserWarning, match="no effect on a saved artifact"):
        pool = pinf.PredictorPool(cfg, size=2)
    p0, p1 = pool.retrieve(0), pool.retrieve(1)
    xn = _x(5, 2, 8)
    h = p0.get_input_handle("x0")
    h.copy_from_cpu(xn)
    assert p0.get_input_names() == ["x0"]
    p0.run()
    got = p0.get_output_handle("out0").copy_to_cpu()
    np.testing.assert_array_equal(got, p1.run([xn])[0])
    # the graph path, a stand-in capturing: one capture, then replays
    p1._graphs = True
    p1._graph_cache = GraphCache("cpu", counters=launch_counters,
                                 capture=_stub_capture,
                                 weights=module_tensors(p1._loaded.module))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        # (on the CPU an output shares the graph buffer: copy it)
        outs = [p1.run([_x(s, 2, 8)])[0].copy() for s in (5, 6, 5)]
    np.testing.assert_array_equal(outs[0], got)
    np.testing.assert_array_equal(outs[2], got)
    assert not np.array_equal(outs[1], got)
    assert p1._graph_cache.captures == 1
    assert sum(g.graph.replays for g in p1._graph_cache.graphs.values()) == 2
