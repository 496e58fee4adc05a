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

**CUDA graphs.**  The reference compiles ``greedy_decode``'s whole loop
into one program cached on the model (``model._decode_cache``, keyed by
(n, L, B, S), at most 8 entries) and ``generate``'s static forward through
``to_static``.  On CUDA the port captures one decode step instead, shared
by both functions: the model carries a ``jit.graphs.GraphCache``
(``model._decode_graphs``) whose key ``("decode", B, L)`` owns the step's
state (``_Rings``: a ``(k_buf, v_buf, pos)`` ring per layer, one pos for
all of them, and the token buffer [B, 1] int32) and the graph of one
decode forward of the token buffer over the rings, which returns the
logits [B, 1, V] and copies the new pos into the rings' pos in place.
The kernels read pos on the device, so one capture serves every position,
prompt length and token budget of a (B, L).  A call sets pos to 0, runs
the prefill eagerly over the key's rings, then per token writes the token
buffer (``greedy_decode``: the argmax, on the device; ``generate``: its
host-side choice) and replays.  A key's first decode step runs eagerly and
is then captured (a capture runs no kernel).  Ring rows left by an earlier
call are never read: B2 reads cols <= pos, B1 cols <= pos + i.  At most 8
keys are held, as in the reference; a 9th drops the oldest key's graph and
rings (2.1 GB at 7B, B 8, L 512).

Weights: the graphs read the parameters' memory.  ``load_numpy_state_dict``,
``load_state_dict`` and the optimizers write in place, and the graphs read
the new values.  Operations that replace a parameter or buffer tensor
(``Module.to`` / ``.cuda()`` / ``.bfloat16()``, ``load_state_dict(...,
assign=True)``, assigning a new ``Parameter``) move it to another address:
the next call sees that (``GraphCache.watch``), drops every graph and ring
of the model and captures again.  A submodule swapped in after the first
call is not seen: call ``model._decode_graphs.clear()``.

The private ``model._graphs = False`` runs the eager loop on CUDA (fresh
rings each call), for the tests and ``chip_smoke.py``; a model on the CPU
runs it always and captures nothing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..framework.random import Generator
from ..jit.graphs import GraphCache, module_tensors
from ..ops.hopper import launch_counters
from ..tensor.search import top_p_sampling
from .llama import _DTYPES

__all__ = ["generate", "greedy_decode"]

MAX_DECODE_KEYS = 8     # the reference's bound on model._decode_cache


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _ring_length(model, S: int, max_new_tokens: int,
                 max_length: Optional[int]) -> int:
    """The KV ring's rows for a prompt of S and the budget; raises where
    the reference's ``_make_static_caches`` does."""
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
    return L


class _Rings:
    """A static decode's state on the model's device: per layer a ring
    (k_buf, v_buf, pos), k_buf/v_buf [B, L, KVH, D] in the model's dtype,
    every layer's pos the one 0-d int32 tensor ``pos``; and the token
    buffer ``tok`` [B, 1] int32 a decode step reads."""

    def __init__(self, model, B: int, L: int):
        cfg = model.config
        dev = _model_device(model)
        shape = (B, L, cfg.num_key_value_heads, cfg.head_dim)
        dt = _DTYPES[cfg.dtype]
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.caches = [(torch.zeros(shape, dtype=dt, device=dev),
                        torch.zeros(shape, dtype=dt, device=dev), self.pos)
                       for _ in range(cfg.num_hidden_layers)]
        self.tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)

    def forward(self, model, ids):
        """model(ids) over the rings -> logits; the rows go into the rings
        and the new pos into ``pos``, in place."""
        logits, caches = model(ids, caches=self.caches)
        self.pos.copy_(caches[-1][2])
        return logits


def _decode_graphs(model) -> Optional[GraphCache]:
    """The model's decode-step graphs (made on first use), or None for the
    eager loop: a model on the CPU, or ``model._graphs`` False."""
    dev = _model_device(model)
    if not getattr(model, "_graphs", dev.type == "cuda"):
        return None
    cache = getattr(model, "_decode_graphs", None)
    if cache is None:
        cache = model._decode_graphs = GraphCache(
            dev, counters=launch_counters, max_keys=MAX_DECODE_KEYS,
            weights=module_tensors(model))
    cache.watch()
    return cache


def _decoder(model, B: int, S: int, max_new_tokens: int,
             max_length: Optional[int]):
    """-> (rings, step): the rings of a static decode of B rows with pos
    at 0, and ``step()``, one decode forward of ``rings.tok`` -> logits
    [B, 1, V].  On graphs the rings are those of the model's key
    ("decode", B, L) and ``step`` replays its graph; eager, fresh rings and
    the forward itself."""
    L = _ring_length(model, S, max_new_tokens, max_length)
    graphs = _decode_graphs(model)
    if graphs is None:
        rings = _Rings(model, B, L)
        return rings, lambda: rings.forward(model, rings.tok)
    key = ("decode", B, L)
    rings = graphs.state(key, lambda: _Rings(model, B, L))
    rings.pos.zero_()

    def step():
        return graphs.run(key, lambda: rings.forward(model, rings.tok))
    return rings, step


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
            rings, step = _decoder(model, B, S, max_new_tokens, max_length)

            def fwd(x, prefill=False):
                if generator is not None:
                    generator.next_key()   # the reference's per-call key
                if prefill:
                    return rings.forward(model, x)
                rings.tok.copy_(x)
                return step()
        else:
            shape = (B, 0, cfg.num_key_value_heads, cfg.head_dim)
            caches = [(torch.zeros(shape, dtype=dt, device=dev),
                       torch.zeros(shape, dtype=dt, device=dev))
                      for _ in range(cfg.num_hidden_layers)]

            def fwd(x, prefill=False):
                nonlocal caches
                logits, caches = model(x, caches=caches)
                return logits
        logits = fwd(ids, prefill=True)
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
            logits = fwd(torch.from_numpy(nxt.astype(np.int32)[:, None]))
    if not out_tokens:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    return torch.as_tensor(np.stack(out_tokens, axis=1).astype(np.int32),
                           device=dev)


def greedy_decode(model, input_ids, max_new_tokens: int,
                  max_length: Optional[int] = None) -> torch.Tensor:
    """Greedy decoding over the static KV ring as one device loop: the
    prefill, then ``max_new_tokens - 1`` single-token decode forwards
    (replays of the model's decode-step graph on CUDA), each fed the
    previous step's argmax on the device.  Nothing waits for the device
    inside the loop (no ``.item()``, no device-to-host copy) once the
    (B, L) key has been captured; the caller reads the tokens.  Returns
    [B, max_new_tokens] int32 on the model's device.  Llama-family
    models."""
    dev = _model_device(model)
    ids = torch.as_tensor(input_ids, device=dev)
    B, S = ids.shape
    if max_new_tokens <= 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    with torch.no_grad():
        rings, step = _decoder(model, B, S, max_new_tokens, max_length)
        toks = torch.empty((B, max_new_tokens), dtype=torch.int32,
                           device=dev)
        logits = rings.forward(model, ids)
        for i in range(max_new_tokens):
            toks[:, i] = torch.argmax(logits[:, -1, :].float(), dim=-1)
            if i == max_new_tokens - 1:
                break
            rings.tok.copy_(toks[:, i:i + 1])
            logits = step()
    return toks
