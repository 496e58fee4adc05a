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
            " paddle_tpu_torch.models.llama\n"
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu')"
            " or m.startswith(('jax.', 'paddle_tpu.'))]\n"
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
                assert root not in ("jax", "jaxlib", "paddle_tpu"), \
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
