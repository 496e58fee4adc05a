"""The port's package contracts: it never imports JAX or paddle_tpu, its
entry points default to CUDA and refuse to run without it unless asked for
the CPU, and its Llama parameters carry paddle_tpu's state_dict one for
one."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.llama import (
    LlamaForCausalLM,
    llama_7b,
    llama_tiny,
    load_numpy_state_dict,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_leaves_no_jax_or_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference.serving,"
            " paddle_tpu_torch.models.llama, paddle_tpu_torch.framework.random,"
            " paddle_tpu_torch.nn.functional, paddle_tpu_torch.tensor.search,"
            " paddle_tpu_torch.models.generation,"
            " paddle_tpu_torch.ops.hopper.flash_attention,"
            " paddle_tpu_torch.ops.hopper.decode_attention,"
            " paddle_tpu_torch.ops.hopper.fused_adamw,"
            " paddle_tpu_torch.optimizer, paddle_tpu_torch.jit,"
            " paddle_tpu_torch.inference, paddle_tpu_torch.quantization,"
            " paddle_tpu_torch.inference.control_plane,"
            " paddle_tpu_torch.inference.kv_fabric,"
            " paddle_tpu_torch.inference.blockwire,"
            " paddle_tpu_torch.distributed.launch.master,"
            " paddle_tpu_torch.distributed.rpc,"
            " paddle_tpu_torch.inference.fleet,"
            " paddle_tpu_torch.tools.serving_worker,"
            " paddle_tpu_torch.tools.chaos_serving,"
            " paddle_tpu_torch.nn.transformer,"
            " paddle_tpu_torch.ops.hopper.int8_matmul,"
            " paddle_tpu_torch.io, paddle_tpu_torch.native,"
            " paddle_tpu_torch.hapi, paddle_tpu_torch.callbacks,"
            " paddle_tpu_torch.metric, paddle_tpu_torch.framework_io,"
            " paddle_tpu_torch.jit.api, paddle_tpu_torch.jit.lazy_segments,"
            " paddle_tpu_torch.jit.serialization,"
            " paddle_tpu_torch.incubate,"
            " paddle_tpu_torch.inference.predictor,"
            " paddle_tpu_torch.static, paddle_tpu_torch.static.passes,"
            " paddle_tpu_torch.static.nn,"
            " paddle_tpu_torch.static.nn.control_flow\n"
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu',"
            " 'ml_dtypes') or m.startswith(('jax.', 'paddle_tpu.',"
            " 'ml_dtypes.'))]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_imports_jax_or_paddle_tpu():
    for path in _port_files():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "paddle_tpu",
                                    "ml_dtypes"), \
                    f"{path} imports {n}"


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("the refusal is only observable without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny())
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    assert ServingEngine(model, device="cpu").device.type == "cpu"
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.nn import transformer as tr

    g = torch.Generator()
    for make in (lambda **kw: pnn.Linear(4, 4, generator=g, **kw),
                 lambda **kw: pnn.Embedding(4, 4, generator=g, **kw),
                 lambda **kw: pnn.LayerNorm(4, **kw),
                 lambda **kw: tr.MultiHeadAttention(8, 2, generator=g, **kw),
                 lambda **kw: tr.TransformerEncoderLayer(8, 2, 16,
                                                         generator=g, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        layer = make(device="cpu")
        assert all(p.device.type == "cpu" for p in layer.parameters())
    # a Predictor takes the device of its layer's parameters; a layer with
    # none runs on the card, so without CUDA it is refused
    from paddle_tpu_torch import inference

    cfg = inference.Config()
    cfg.set_layer(torch.nn.ReLU())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.create_predictor(cfg)
    cfg.set_layer(pnn.LayerNorm(4, device="cpu"))
    assert inference.create_predictor(cfg)._device.type == "cpu"
    # an artifact runs where it was exported: one exported on the card is
    # refused here, by jit.load and by Config(path); a CPU one runs
    import json
    import tempfile

    from paddle_tpu_torch import jit

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model")
        jit.save(pnn.LayerNorm(4, device="cpu"), path,
                 input_spec=[jit.InputSpec([2, 4], "float32")])
        assert jit.load(path)(torch.ones(2, 4)).shape == (2, 4)
        with open(path + ".pdmodel.json") as f:
            meta = json.load(f)
        meta["device"] = "cuda:0"
        with open(path + ".pdmodel.json", "w") as f:
            json.dump(meta, f)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            jit.load(path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            inference.create_predictor(inference.Config(path))
    # static: a placeholder is made on the card unless the CPU is asked
    # for (device= or device_guard); a CPU Executor runs a CPU program
    from paddle_tpu_torch import static

    with static.program_guard(static.Program()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            static.data("x", [2, 4], "float32")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with static.device_guard("gpu"):
                pass
    import paddle_tpu_torch as pt

    prog = static.Program()
    pt.enable_static()
    try:
        with static.program_guard(prog), static.device_guard("cpu"):
            x = static.data("x", [2, 4], "float32")
            y = pnn.LayerNorm(4, device="cpu")(x)
            assert x.device.type == y.device.type == "cpu"
    finally:
        pt.disable_static()
    (out,) = static.Executor(static.cpu_places()[0]).run(
        prog, feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[y])
    assert out.shape == (2, 4)


def test_generation_runs_on_the_model_device():
    """generate and greedy_decode run where the model lives: a CPU model
    (the only kind this machine can build) gives CPU tokens, through the
    plain versions, without a kernel launch; a CUDA model cannot be made
    here."""
    from paddle_tpu_torch.models.generation import generate, greedy_decode
    from paddle_tpu_torch.ops.hopper import decode_attention as da
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LlamaForCausalLM(llama_tiny())
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    ids = np.array([[3, 17, 101, 7]], np.int32)
    launched = (fa.flash_attention_fused.launches,
                da.decode_attention.launches, da.kv_ring_write.launches)
    for out in (generate(model, ids, max_new_tokens=3),
                generate(model, ids, max_new_tokens=3,
                         use_static_cache=True),
                greedy_decode(model, ids, max_new_tokens=3)):
        assert out.device.type == "cpu" and tuple(out.shape) == (1, 3)
    assert (fa.flash_attention_fused.launches, da.decode_attention.launches,
            da.kv_ring_write.launches) == launched


def test_precision_pin():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_state_dict_names_and_shapes_match_paddle_tpu():
    P.seed(3)
    jm = JaxLlama(jax_llama_tiny(num_key_value_heads=2))
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = LlamaForCausalLM(llama_tiny(num_key_value_heads=2), device="cpu")
    ours = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert ours == {k: v.shape for k, v in sd.items()}
    assert len(ours) == 21
    assert ours["llama.layers.0.self_attn.k_proj.weight"] == (128, 64)
    load_numpy_state_dict(pm, sd)
    for k, v in pm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])


def test_load_numpy_state_dict_rejects_mismatches():
    pm = LlamaForCausalLM(llama_tiny(), device="cpu")
    sd = {k: v.numpy().copy() for k, v in pm.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        load_numpy_state_dict(pm, {k: v for k, v in sd.items()
                                   if k != "llama.norm.weight"})
    with pytest.raises(KeyError, match="unexpected"):
        load_numpy_state_dict(pm, {**sd, "llama.extra": np.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        load_numpy_state_dict(pm, {**sd, "llama.norm.weight": np.zeros(3)})


def test_bfloat16_arrays_load_by_raw_bits():
    import ml_dtypes

    pm = LlamaForCausalLM(llama_tiny(dtype="bfloat16"), device="cpu")
    rng = np.random.default_rng(0)
    sd = {k: rng.standard_normal(tuple(v.shape)).astype(ml_dtypes.bfloat16)
          for k, v in pm.state_dict().items()}
    load_numpy_state_dict(pm, sd)
    w = pm.llama.norm.weight
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.view(torch.int16).numpy(),
        sd["llama.norm.weight"].view(np.int16))


def test_llama_7b_geometry():
    cfg = llama_7b(dtype="bfloat16")
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_hidden_layers, cfg.num_attention_heads,
            cfg.head_dim) == (32000, 4096, 11008, 32, 32, 128)
