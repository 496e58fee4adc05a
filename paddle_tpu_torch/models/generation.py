"""Autoregressive generation — the port of ``paddle_tpu/models/generation.py``.

``generate`` decodes greedily or by nucleus sampling with growing
``(k, v)`` caches or the static KV ring; ``greedy_decode`` is the serving
decode loop: one prefill, then one decode forward per token over the ring,
with the argmax on the device and no host sync until the tokens are read.
Both run on the model's device.

The reference runs ``generate(use_static_cache=True)`` through
``jit.to_static``, whose every call takes one key from the default
generator (``paddle_tpu/jit/api.py``); the port has no global generator, so
that mode advances the caller's ``generator`` once per forward instead, and
the same seed gives the reference's sampled tokens in both modes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework.random import Generator
from ..tensor.search import top_p_sampling
from .llama import _DTYPES

__all__ = ["generate", "greedy_decode"]


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _make_static_caches(model, B: int, S: int, max_new_tokens: int,
                        max_length: Optional[int]):
    """Validate and build the per-layer KV rings (k_buf, v_buf, pos) on the
    model's device; pos is a 0-d int32 tensor.  Shared by ``generate``'s
    static branch and ``greedy_decode``."""
    cfg = model.config
    if not getattr(model, "supports_static_kv_cache", False):
        raise ValueError(
            f"{type(model).__name__} does not support static KV caches "
            "(3-tuple ring buffers); use a Llama-family model")
    L = int(max_length or (S + max_new_tokens))
    if L < S + max_new_tokens:
        raise ValueError(
            f"max_length={L} is smaller than prompt ({S}) + max_new_tokens "
            f"({max_new_tokens}); the KV ring would silently overwrite its "
            "last row")
    if L > cfg.max_position_embeddings:
        raise ValueError(
            f"max_length={L} exceeds max_position_embeddings "
            f"({cfg.max_position_embeddings}); rope rows past the table end "
            "would be clamped and rotations silently wrong")
    dev = _model_device(model)
    shape = (B, L, cfg.num_key_value_heads, cfg.head_dim)
    dt = _DTYPES[cfg.dtype]
    caches = [(torch.zeros(shape, dtype=dt, device=dev),
               torch.zeros(shape, dtype=dt, device=dev),
               torch.zeros((), dtype=torch.int32, device=dev))
              for _ in range(cfg.num_hidden_layers)]
    return L, caches


def generate(model, input_ids, max_new_tokens: int = 32,
             do_sample: bool = False, top_p: float = 1.0,
             temperature: float = 1.0, eos_token_id: Optional[int] = None,
             use_static_cache: bool = False,
             max_length: Optional[int] = None,
             generator: Optional[Generator] = None) -> torch.Tensor:
    """Greedy or nucleus decoding with KV caches.

    ``model(ids, caches=...)`` returns (logits, new caches), as
    LlamaForCausalLM's forward.  Returns the generated ids [B, n] int32 on
    the model's device, n <= max_new_tokens (the prompt is not included).
    ``do_sample=True`` draws with ``top_p_sampling`` from ``generator`` (a
    ``framework.random.Generator``) and raises ``ValueError`` without one.
    ``use_static_cache=True``: per-layer KV rings of ``max_length`` rows
    (default prompt + max_new_tokens), written in place, every decode step
    of the same shapes."""
    cfg = getattr(model, "config", None)
    if cfg is None:
        raise ValueError("generate() needs a model with a .config describing "
                         "num_hidden_layers/num_key_value_heads/head_dim "
                         "(e.g. LlamaForCausalLM)")
    if do_sample and generator is None:
        raise ValueError("generate(do_sample=True) draws from an explicit "
                         "generator=framework.random.Generator(seed)")
    dev = _model_device(model)
    ids = torch.as_tensor(input_ids, device=dev)
    B, S = ids.shape
    dt = _DTYPES[cfg.dtype]

    with torch.no_grad():
        if use_static_cache:
            _, caches = _make_static_caches(model, B, S, max_new_tokens,
                                            max_length)

            def fwd(x, c):
                if generator is not None:
                    generator.next_key()   # the reference's per-call key
                return model(x, caches=c)
        else:
            shape = (B, 0, cfg.num_key_value_heads, cfg.head_dim)
            caches = [(torch.zeros(shape, dtype=dt, device=dev),
                       torch.zeros(shape, dtype=dt, device=dev))
                      for _ in range(cfg.num_hidden_layers)]

            def fwd(x, c):
                return model(x, caches=c)
        logits, caches = fwd(ids, caches)
        out_tokens = []
        finished = np.zeros((B,), bool)
        for step_i in range(max_new_tokens):
            last = logits[:, -1, :].float()
            if temperature != 1.0:
                last = last / max(temperature, 1e-6)
            if do_sample:
                probs = torch.softmax(last, dim=-1)
                _, idx = top_p_sampling(
                    probs, torch.full((B,), float(top_p), device=dev),
                    generator)
                nxt = idx.reshape(B).cpu().numpy()
            else:
                nxt = torch.argmax(last, dim=-1).cpu().numpy()
            if eos_token_id is not None:
                nxt = np.where(finished, eos_token_id, nxt)
                finished |= nxt == eos_token_id
            out_tokens.append(nxt)
            done = eos_token_id is not None and finished.all()
            if done or step_i == max_new_tokens - 1:
                break  # budget spent: no decode forward to discard
            cur = torch.as_tensor(nxt.astype(np.int32)[:, None], device=dev)
            logits, caches = fwd(cur, caches)
    if not out_tokens:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    return torch.as_tensor(np.stack(out_tokens, axis=1).astype(np.int32),
                           device=dev)


def greedy_decode(model, input_ids, max_new_tokens: int,
                  max_length: Optional[int] = None) -> torch.Tensor:
    """Greedy decoding over the static KV ring as one device loop: the
    prefill, then ``max_new_tokens - 1`` single-token decode forwards, each
    fed the previous step's argmax on the device.  Nothing waits for the
    device inside the loop (no ``.item()``, no device-to-host copy); the
    caller reads the tokens.  Returns [B, max_new_tokens] int32 on the
    model's device.  Llama-family models."""
    dev = _model_device(model)
    ids = torch.as_tensor(input_ids, device=dev)
    B, S = ids.shape
    if max_new_tokens <= 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    _, caches = _make_static_caches(model, B, S, max_new_tokens, max_length)

    def argmax_last(logits):
        return torch.argmax(logits[:, -1, :].float(), dim=-1).to(
            torch.int32)[:, None]

    with torch.no_grad():
        logits, caches = model(ids, caches=caches)
        toks = [argmax_last(logits)]
        for _ in range(max_new_tokens - 1):
            logits, caches = model(toks[-1], caches=caches)
            toks.append(argmax_last(logits))
    return torch.cat(toks, dim=1)
