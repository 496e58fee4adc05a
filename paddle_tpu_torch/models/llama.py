"""Llama model family — the port of ``paddle_tpu/models/llama.py``.

This slice carries the configuration (``LlamaConfig``, ``llama_tiny``,
``llama_7b``, ``_rope_cache``) and the parameter structure of
``LlamaForCausalLM`` with the reference's ``state_dict`` names and
layouts, so a paddle_tpu checkpoint loads one for one
(``load_numpy_state_dict``).  The serving engine
(``inference/serving.py``) runs the forward over these parameters.
``LlamaForCausalLM.forward`` and ``generate`` come with the static-ring
decode path in the next slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn import Embedding, Linear, RMSNorm

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM", "llama_tiny",
           "llama_7b", "load_numpy_state_dict"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    recompute: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def llama_tiny(**kw) -> LlamaConfig:
    return LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=352,
                       num_hidden_layers=2, num_attention_heads=4,
                       max_position_embeddings=256, **kw)


def llama_7b(**kw) -> LlamaConfig:
    return LlamaConfig(**kw)


def _rope_cache(config: LlamaConfig):
    dim = config.head_dim
    inv_freq = 1.0 / (config.rope_theta
                      ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(config.max_position_embeddings, dtype=np.float64)
    freqs = np.outer(t, inv_freq)  # [S, dim/2]
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


class _Init:
    """Where and how parameters are made: one device, one dtype, one
    seeded generator shared by every layer in construction order."""

    def __init__(self, device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator):
        self.device, self.dtype, self.generator = device, dtype, generator

    def linear(self, n_in: int, n_out: int) -> Linear:
        return Linear(n_in, n_out, device=self.device, dtype=self.dtype,
                      generator=self.generator)

    def norm(self, hidden: int, eps: float) -> RMSNorm:
        return RMSNorm(hidden, eps, device=self.device, dtype=self.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        h, d = config.hidden_size, config.head_dim
        self.q_proj = init.linear(h, config.num_attention_heads * d)
        self.k_proj = init.linear(h, config.num_key_value_heads * d)
        self.v_proj = init.linear(h, config.num_key_value_heads * d)
        self.o_proj = init.linear(config.num_attention_heads * d, h)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = init.linear(h, m)
        self.up_proj = init.linear(h, m)
        self.down_proj = init.linear(m, h)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.self_attn = LlamaAttention(config, init)
        self.mlp = LlamaMLP(config, init)
        self.input_layernorm = init.norm(config.hidden_size,
                                         config.rms_norm_eps)
        self.post_attention_layernorm = init.norm(config.hidden_size,
                                                  config.rms_norm_eps)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=init.device, dtype=init.dtype,
                                      generator=init.generator)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, init)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = init.norm(config.hidden_size, config.rms_norm_eps)


class LlamaForCausalLM(nn.Module):
    """Parameters of the causal LM.  ``device=None`` means CUDA and raises
    ``RuntimeError`` without it; pass ``device="cpu"`` for the CPU.
    Parameters are made in ``config.dtype`` on the device, drawn from a
    ``torch.Generator`` there seeded with ``seed``."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if config.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {config.dtype!r}")
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
        init = _Init(dev, _DTYPES[config.dtype], generator)
        self.config = config
        self.llama = LlamaModel(config, init)
        self.lm_head = (None if config.tie_word_embeddings
                        else init.linear(config.hidden_size,
                                         config.vocab_size))

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "LlamaForCausalLM.forward/generate come with the static-ring "
            "decode slice (flash attention, decode attention and the KV ring "
            "write); serve through inference.serving.ServingEngine")


def _tensor_from_numpy(arr: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; a bfloat16 array (ml_dtypes) is read by its
    raw 16-bit pattern, so no import of ml_dtypes is needed."""
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def load_numpy_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]):
    """Copy ``{name: np.ndarray}`` (paddle_tpu's ``state_dict`` as numpy)
    into ``model``'s parameters, converting to each parameter's dtype and
    device.  Raises ``KeyError`` on a missing or extra name and
    ``ValueError`` on a shape mismatch, before copying anything."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(sd))
    extra = sorted(set(sd) - set(params))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, p in params.items():
        if tuple(sd[name].shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(sd[name].shape)} does "
                             f"not match the parameter's {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(_tensor_from_numpy(np.asarray(sd[name])))
    return model
