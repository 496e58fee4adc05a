"""GPT family — the port of ``paddle_tpu/models/gpt.py``.

``GPTConfig``, ``gpt_tiny`` and ``gpt3_1_3b`` as the reference's;
``GPTForCausalLM`` with the reference's sub-module names, so its
``state_dict`` loads one for one (``nn.load_numpy_state_dict``).  GPT-2/3
style: learned positions (``wpe``), pre-LN ``LayerNorm``, a gelu MLP and
multi-head attention with biases (``ParallelLinear``: ``qkv`` and
``fc_in`` in the column form, the bias inside the product's op;
``out_proj`` and ``fc_out`` in the row form, the bias added after it).

The fused ``qkv`` output is split 3-major (``[b, s, 3, heads, head_dim]``:
all q, then k, then v), as the reference's, so its ``qkv.weight`` computes
the same heads.  Attention:

- no mask: causal flash attention (kernel B1; its backward B8), with or
  without a growing ``(k, v)`` cache per layer; a cached step's queries sit
  at the cache's end (B1's bottom-right causal rule, ``Sq`` may be 1);
- an additive ``attn_mask``: ``scaled_dot_product_attention``, the plain
  masked attention, as in the reference.

There is no static KV ring: ``generate(use_static_cache=True)`` and
``greedy_decode`` raise ``ValueError`` for a GPT, as the reference's do.

Dtypes follow the reference's jnp promotion, not torch's defaults.  The
parameters are float32 (the reference's default dtype) whatever
``config.dtype``; with ``dtype="bfloat16"`` only the sum of the
embeddings is cast to bfloat16, so the first norm normalizes in bfloat16
and everything after it promotes to float32, and a growing cache started
as bfloat16 zeros becomes float32 at its first concatenation.  Under AMP
each op casts as its reference tag says (``embedding``, ``add``,
``layer_norm``, ``linear``, ``concat``, ``flash_attention`` / ``sdpa``,
``gelu``); under ``amp.decorate(level="O2")`` every product and the
attention run in bfloat16 and B1/B8 take their tensor-core instances.

``config.recompute``, while training without caches, runs each block under
``torch.utils.checkpoint`` with Llama's ``_recompute_contexts`` (the
reference's ``recompute``), so its kernels launch again in the backward.
``gpt_pipeline_descs`` (pipeline parallelism) is not ported (ROADMAP A8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..nn import Embedding, LayerNorm, ParallelLinear
from ..nn import functional as F
from ..nn.transformer import _add, _concat
from .llama import _recompute_contexts

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt3_1_3b"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 2048
    intermediate_size: Optional[int] = None
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 2048
    layer_norm_epsilon: float = 1e-5
    use_flash_attention: bool = True
    recompute: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    # generate() compatibility (no GQA in GPT)
    @property
    def num_key_value_heads(self) -> int:
        return self.num_attention_heads


def gpt_tiny(**kw) -> GPTConfig:
    return GPTConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=4, max_position_embeddings=256, **kw)


def gpt3_1_3b(**kw) -> GPTConfig:
    """GPT-3 XL shape (BASELINE.md's GPT-3 1.3B rung)."""
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_hidden_layers=24,
                     num_attention_heads=16, max_position_embeddings=2048,
                     **kw)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.num_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.qkv = ParallelLinear(h, 3 * h, has_bias=None, **kw)
        self.out_proj = ParallelLinear(h, h, has_bias=True, row=True, **kw)

    def forward(self, hidden, attn_mask=None, cache=None):
        """hidden [b, s, E] (normed) -> out [b, s, E], and the layer's
        grown ``(k, v)`` when ``cache`` is given."""
        b, s = hidden.shape[0], hidden.shape[1]
        nh, hd = self.num_heads, self.head_dim
        q, k, v = self.qkv(hidden).view(b, s, 3, nh, hd).unbind(2)
        new_cache = None
        if cache is not None:
            k = _concat(cache[0], k)
            v = _concat(cache[1], v)
            new_cache = (k, v)
        if attn_mask is None:
            out, _ = F.flash_attention(q, k, v, causal=True)
        else:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        out = self.out_proj(out.reshape(b, s, nh * hd))
        if cache is not None:
            return out, new_cache
        return out


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.ln_1 = LayerNorm(h, eps, device=dev, dtype=dtype)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(h, eps, device=dev, dtype=dtype)
        self.fc_in = ParallelLinear(h, config.intermediate_size,
                                    has_bias=None, **kw)
        self.fc_out = ParallelLinear(config.intermediate_size, h,
                                     has_bias=True, row=True, **kw)

    def forward(self, hidden, attn_mask=None, cache=None):
        attn_out = self.attn(self.ln_1(hidden), attn_mask, cache)
        if cache is not None:
            attn_out, new_cache = attn_out
        hidden = _add(hidden, attn_out)
        hidden = _add(hidden, self.fc_out(F.gelu(self.fc_in(
            self.ln_2(hidden)))))
        if cache is not None:
            return hidden, new_cache
        return hidden


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.wte = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **kw)
        self.h = nn.ModuleList([GPTBlock(config, **kw)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, config.layer_norm_epsilon,
                              device=dev, dtype=dtype)

    def forward(self, input_ids, attn_mask=None, caches=None):
        """input_ids [B, S] -> final-normed hidden [B, S, E], and the new
        caches when ``caches`` is given (positions continue from the first
        cache's length)."""
        s = input_ids.shape[1]
        offset = 0 if caches is None else int(caches[0][0].shape[1])
        pos = torch.arange(offset, offset + s, device=input_ids.device)
        hidden = _add(self.wte(input_ids), self.wpe(pos))
        if self.config.dtype == "bfloat16":
            hidden = hidden.to(torch.bfloat16)
        recompute = (self.config.recompute and caches is None
                     and self.training and torch.is_grad_enabled())
        new_caches = []
        for i, block in enumerate(self.h):
            if caches is not None:
                hidden, c = block(hidden, attn_mask, caches[i])
                new_caches.append(c)
            elif recompute:
                hidden = checkpoint(block, hidden, attn_mask,
                                    use_reentrant=False,
                                    preserve_rng_state=False,
                                    context_fn=_recompute_contexts)
            else:
                hidden = block(hidden, attn_mask)
        hidden = self.ln_f(hidden)
        if caches is not None:
            return hidden, new_caches
        return hidden


class GPTForCausalLM(nn.Module):
    """The causal LM.  ``device=None`` means CUDA and raises
    ``RuntimeError`` without it; pass ``device="cpu"`` for the CPU, where
    every kernel runs its plain version.  Parameters are made in ``dtype``
    (float32, the reference's, by default) on the device, drawn from a
    ``torch.Generator`` there seeded with ``seed``."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if config.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32 or bfloat16, got "
                             f"{config.dtype!r}")
        generator = torch.Generator(device=dev)
        generator.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=generator)
        self.config = config
        self.gpt = GPTModel(config, **kw)
        self.lm_head = ParallelLinear(config.hidden_size, config.vocab_size,
                                      **kw)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids, attn_mask=None, caches=None):
        """input_ids [B, S] (a tensor on the model's device, or anything
        ``torch.as_tensor`` takes) -> logits [B, S, V], or (logits, new
        caches) when ``caches`` is given: per layer an empty or growing
        ``(k, v)`` [B, T, H, D]."""
        ids = torch.as_tensor(input_ids, device=self.device)
        out = self.gpt(ids, attn_mask, caches)
        hidden = out[0] if caches is not None else out
        logits = self.lm_head(hidden)
        if caches is not None:
            return logits, out[1]
        return logits

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class GPTPretrainingCriterion(nn.Module):
    """Shifted next-token cross-entropy over logits [B, S, V] and labels
    [B, S]."""

    def forward(self, logits, labels):
        shift_logits = logits[:, :-1, :]
        shift_labels = labels[:, 1:]
        return F.cross_entropy(
            shift_logits.reshape(-1, shift_logits.shape[-1]),
            shift_labels.reshape(-1))
