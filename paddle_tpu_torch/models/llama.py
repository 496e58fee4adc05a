"""Llama model family — the port of ``paddle_tpu/models/llama.py``.

``LlamaConfig``, ``llama_tiny``, ``llama_7b`` and ``_rope_cache`` as the
reference's; ``LlamaForCausalLM`` with the reference's ``state_dict`` names
and layouts, so a paddle_tpu checkpoint loads one for one
(``load_numpy_state_dict``), and its forward in the reference's three cache
modes:

- no cache: causal flash attention (kernel B1);
- a growing ``(k, v)`` cache per layer: the new keys are appended and the
  unmasked causal SDPA runs over them (B1, bottom-right, ``Sq`` may be 1);
- the static KV ring ``(k_buf, v_buf, pos)`` per layer
  (``_static_cache_attn``): rope's ring mode (K2 with B3 folded in) writes
  the step's rotated k and its v rows into the ring in the launch that
  rotates q; a decode step attends with B2, a prefill runs B1 over the
  ring with the query offset ``pos``.  The ring is updated IN PLACE (the
  reference returns new buffers); ``pos`` stays on the device.

The trunk's norms are K1 (the residual add fused into each norm after the
first), rope K2 and SwiGLU K3; the projections are ``torch.matmul``, as the
reference leaves them to XLA, a decode step over a cache taking q, k and v
from one product over their concatenated weights (the reference's
``qkv_fused``; ``LlamaForCausalLM.qkv_weights`` makes the concatenations,
which a caller running many steps, ``models/generation.py``, makes once
and passes as ``qkv_weights=``; without them a step concatenates).  The serving engine
(``inference/serving.py``) runs its own forward over these parameters.

Training: the forward is differentiable (K1's backward is the reference's
jnp vjp in torch ops, K2's is K2 with -sin, K3's is B6b, B1's is B8).  With
``config.recompute``, while training and without caches, each decoder
layer runs under ``torch.utils.checkpoint`` (the reference's
``recompute``, ``distributed/fleet/utils/recompute.py``), so its forward
kernels launch again in the backward.  ``LlamaPretrainingCriterion`` is the
shifted next-token loss over the logits; ``pretraining_loss`` the same loss
through the chunked head (``_chunked_lm_loss``), each chunk checkpointed.

AMP (``amp.auto_cast``): each op casts its inputs by the reference's tag
(``embedding``, ``rms_norm`` on the black list, ``linear`` and
``flash_attention`` on the white list, ``fused_rope``, ``silu`` /
``multiply``, ``add``, ``concat`` (a growing cache), ``fused_lm_loss``,
``qkv_fused`` on neither list, so O1 keeps a float32 model's decode step
in float32; on the ring ``sdpa`` and ``decode_attention``).
The reference adds the residual
("add") and then norms ("rms_norm"), two ops with two casts, so under AMP
the port runs them as two too (``_add_norm``: the add, then K1 on the
float32 sum) instead of K1's fused residual add.  A recomputed layer runs
in the backward, outside the caller's ``auto_cast``:
``_recompute_contexts`` restores the forward's AMP state and random
counter around the recomputation.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..amp.auto_cast import amp_cast, is_auto_cast_enabled
from ..amp.auto_cast import restore as amp_restore
from ..amp.auto_cast import snapshot as amp_snapshot
from ..device import resolve_device
from ..framework.random import default_generator
from ..jit import trace_state
from ..nn import Embedding, ParallelLinear, RMSNorm, load_numpy_state_dict
from ..nn import functional as F
from ..nn.transformer import _concat
from ..ops.hopper.decode_attention import decode_attention, kv_ring_write
from ..ops.hopper.flash_attention import flash_attention_fwd
from ..ops.hopper.fused_norm import rms_norm_fused, rms_norm_residual_fused
from ..ops.hopper.fused_ops import rope_fused, rope_ring_fused, swiglu_fused

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny", "llama_7b",
           "load_numpy_state_dict", "apply_rotary_pos_emb"]

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

    def linear(self, n_in: int, n_out: int) -> ParallelLinear:
        return ParallelLinear(n_in, n_out, device=self.device,
                              dtype=self.dtype, generator=self.generator)

    def norm(self, hidden: int, eps: float) -> RMSNorm:
        return RMSNorm(hidden, eps, device=self.device, dtype=self.dtype)


def apply_rotary_pos_emb(q, k, cos, sin, position_offset=0):
    """q [B, S, H, D], k [B, S, KVH, D]; cos/sin [Smax, D/2] float32 ->
    rotated (q, k) through kernel K2.  ``position_offset`` is an int (the
    window is a view of the table) or a 0-d integer tensor on the device:
    K2 then reads it and takes the rows ``lax.dynamic_slice`` takes
    (``clamp(off, 0, Smax - S) + s``, a negative off counted from the end
    first) in its one launch (no host sync)."""
    q, k, cos, sin = amp_cast("fused_rope", q, k, cos, sin)
    if cos.dtype != torch.float32:
        # O2 casts the tables as the reference's op does; K2 reads them
        # at float32 (their low-precision values exactly)
        cos, sin = cos.float(), sin.float()
    if isinstance(position_offset, torch.Tensor):
        return rope_fused(q, k, cos, sin, position_offset=position_offset)
    S = q.shape[1]
    return rope_fused(q, k, cos[position_offset:position_offset + S],
                      sin[position_offset:position_offset + S])


def _add_norm(x, residual, norm: RMSNorm):
    """(norm(h), h) for the residual stream h = x + residual (h = x where
    ``residual`` is None).  One K1 launch with the add fused; under AMP the
    reference's two ops, the add ("add") and then the norm ("rms_norm",
    black-listed: K1 on the float32 sum), so the stream keeps the dtype the
    reference's add gives it."""
    if not is_auto_cast_enabled():
        if residual is None:
            return rms_norm_fused(x, norm.weight, norm.epsilon), x
        return rms_norm_residual_fused(x, residual, norm.weight,
                                       norm.epsilon)
    if residual is not None:
        x, residual = amp_cast("add", x, residual)
        x = residual + x
    return norm(x), x


def _recompute_contexts():
    """``checkpoint``'s ``context_fn``: the forward runs as it is; the
    recomputation in the backward runs under the AMP state and from the
    random counter the forward started with (the step's ``TraceContext``,
    or the default generator outside a step), so it casts and draws as
    the forward did."""
    amp = amp_snapshot()
    ctx = trace_state.current()
    replay = None if ctx is None else ctx.fork()
    gen = default_generator()
    gen_state = gen.get_state()

    @contextlib.contextmanager
    def recompute():
        later = gen.get_state()
        if replay is None:
            gen.set_state(gen_state)
        try:
            with amp_restore(amp), trace_state.activate(replay):
                yield
        finally:
            if replay is None:
                gen.set_state(later)

    return contextlib.nullcontext(), recompute()


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        h, d = config.hidden_size, config.head_dim
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = d
        self.q_proj = init.linear(h, config.num_attention_heads * d)
        self.k_proj = init.linear(h, config.num_key_value_heads * d)
        self.v_proj = init.linear(h, config.num_key_value_heads * d)
        self.o_proj = init.linear(config.num_attention_heads * d, h)

    def forward(self, hidden, cos, sin, attn_mask=None, cache=None,
                qkv_weight=None):
        """hidden [b, s, E] (normed) -> out [b, s, E], and the layer's new
        cache when ``cache`` is given.  A decode step (s == 1 over a
        cache) projects q, k and v with one product, the reference's
        ``qkv_fused`` op (``_qkv_fused``, over ``qkv_weight`` where
        given); otherwise three "linear"s."""
        b, s = hidden.shape[0], hidden.shape[1]
        nh, nkv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        if s == 1 and cache is not None:
            qkv = self._qkv_fused(hidden, qkv_weight)
            q = qkv[..., :nh * hd].view(b, s, nh, hd)
            k = qkv[..., nh * hd:(nh + nkv) * hd].view(b, s, nkv, hd)
            v = qkv[..., (nh + nkv) * hd:].view(b, s, nkv, hd)
        else:
            q = self.q_proj(hidden).view(b, s, nh, hd)
            k = self.k_proj(hidden).view(b, s, nkv, hd)
            v = self.v_proj(hidden).view(b, s, nkv, hd)
        if cache is not None and len(cache) == 3:
            return self._static_cache_attn(q, k, v, cos, sin, cache, b, s)
        offset = 0 if cache is None else cache[0].shape[1]
        q, k = apply_rotary_pos_emb(q, k, cos, sin, position_offset=offset)
        new_cache = None
        if cache is not None:
            k = _concat(cache[0], k)
            v = _concat(cache[1], v)
            new_cache = (k, v)
        if attn_mask is None and cache is None:
            out, _ = F.flash_attention(q, k, v, causal=True)
        else:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                 is_causal=attn_mask is None)
        out = self.o_proj(out.reshape(b, s, nh * hd))
        if cache is not None:
            return out, new_cache
        return out

    def qkv_weight(self, out=None) -> torch.Tensor:
        """The [E, (nh + 2 nkv) hd] concatenation of the q, k and v
        weights, written into ``out`` in place where given."""
        ws = [self.q_proj.weight, self.k_proj.weight, self.v_proj.weight]
        return torch.cat(ws, dim=1, out=out)

    def _qkv_fused(self, hidden, w=None):
        """hidden [b, 1, E] @ ``w``, the concatenation of the three
        weights (``qkv_weight``; made here when None), cast to hidden's
        dtype, under the reference's tag "qkv_fused" (on neither AMP list:
        O1 keeps float32, O2 casts to the low dtype)."""
        if w is None:
            w = self.qkv_weight()
        hidden, w = amp_cast("qkv_fused", hidden, w)
        return hidden @ w.to(hidden.dtype)

    def _static_cache_attn(self, q, k, v, cos, sin, cache, b, s):
        """The fixed-size KV ring: cache = (k_buf [B, L, KVH, D], v_buf,
        pos), pos a 0-d int32 tensor on the device.  Rope's ring mode
        rotates q and k by the table rows at pos and writes this step's
        rotated k and v rows at ring rows pos .. pos + s - 1 INTO the ring
        (``dynamic_update_slice``'s start; one K2 launch, B3 folded in, in
        place: the returned buffers are the given ones), then a decode step
        (s == 1) attends with kernel B2 over cols <= pos, and a prefill with
        B1 over the ring, row i seeing cols <= pos + i (the reference's
        mask).  Returns (out, (k_buf, v_buf, pos + s)).

        Under AMP q, k and v may come in another dtype than the ring's (a
        float32 model's prefill under O1 projects in bfloat16): then, as
        the reference's ops do, rope rotates in their dtype (K2), the ring
        write casts the rows into the ring's dtype (B3, the reference's
        ``astype(buf.dtype)``: rounded, then widened), and the attention
        casts its inputs under the reference's tag ("sdpa" for a prefill,
        "decode_attention" for a step)."""
        kbuf, vbuf, pos = cache
        if q.dtype == k.dtype == v.dtype == kbuf.dtype:
            q = rope_ring_fused(q, k, v, cos, sin, kbuf, vbuf, pos)
        else:
            q, k = apply_rotary_pos_emb(q, k, cos, sin, position_offset=pos)
            kv_ring_write(kbuf, vbuf, k, v, pos)
        if s == 1:
            out = decode_attention(
                *amp_cast("decode_attention", q, kbuf, vbuf), pos)
        else:
            qa, ka, va = amp_cast("sdpa", q, kbuf, vbuf)
            out = flash_attention_fwd(qa, ka, va, causal=True, q_offset=pos)
        out = self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))
        return out, (kbuf, vbuf, pos + s)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = init.linear(h, m)
        self.up_proj = init.linear(h, m)
        self.down_proj = init.linear(m, h)

    def forward(self, x):
        """down(silu(gate(x)) * up(x)), the gating in kernel K3."""
        (gate,) = amp_cast("silu", self.gate_proj(x))
        (up,) = amp_cast("multiply", self.up_proj(x))
        return self.down_proj(swiglu_fused(gate, up))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, init: _Init):
        super().__init__()
        self.self_attn = LlamaAttention(config, init)
        self.mlp = LlamaMLP(config, init)
        self.input_layernorm = init.norm(config.hidden_size,
                                         config.rms_norm_eps)
        self.post_attention_layernorm = init.norm(config.hidden_size,
                                                  config.rms_norm_eps)

    def forward(self, x, residual, cos, sin, attn_mask=None, cache=None,
                qkv_weight=None):
        """The reference's ``residual + attn(ln1(h))`` then
        ``+ mlp(ln2(.))`` over the layer input ``h = x + residual``
        (``residual`` None: h = x), with each residual add fused into the
        norm after it (K1; under AMP the reference's add, then the norm:
        ``_add_norm``).  Returns (mlp_out, residual) — the layer's
        output is their sum, left for the next norm to take — and the new
        cache when ``cache`` is given (``qkv_weight``: ``LlamaAttention``'s)."""
        h, residual = _add_norm(x, residual, self.input_layernorm)
        attn = self.self_attn(h, cos, sin, attn_mask, cache, qkv_weight)
        new_cache = None
        if cache is not None:
            attn, new_cache = attn
        h2, residual = _add_norm(attn, residual,
                                 self.post_attention_layernorm)
        out = self.mlp(h2)
        if cache is not None:
            return out, residual, new_cache
        return out, residual


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
        cos, sin = _rope_cache(config)
        self.register_buffer("rope_cos", torch.as_tensor(cos,
                                                         device=init.device),
                             persistent=False)
        self.register_buffer("rope_sin", torch.as_tensor(sin,
                                                         device=init.device),
                             persistent=False)

    def forward(self, input_ids, attn_mask=None, caches=None,
                qkv_weights=None):
        """input_ids [B, S] -> final-normed hidden [B, S, E], and the new
        caches when ``caches`` is given (``qkv_weights``: a decode step's
        per-layer q/k/v concatenations, ``LlamaForCausalLM.qkv_weights``)."""
        x = self.embed_tokens(input_ids)
        if self.config.dtype == "bfloat16":
            x = x.to(torch.bfloat16)
        cos, sin = self.rope_cos, self.rope_sin
        residual = None
        new_caches = []
        recompute = (self.config.recompute and caches is None
                     and self.training and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, residual, c = layer(
                    x, residual, cos, sin, attn_mask, caches[i],
                    None if qkv_weights is None else qkv_weights[i])
                new_caches.append(c)
            elif recompute:
                # the layer takes and returns (x, residual): checkpointed
                # whole, its activations rebuilt in the backward
                x, residual = checkpoint(layer, x, residual, cos, sin,
                                         attn_mask, use_reentrant=False,
                                         preserve_rng_state=False,
                                         context_fn=_recompute_contexts)
            else:
                x, residual = layer(x, residual, cos, sin, attn_mask)
        hidden, _ = _add_norm(x, residual, self.norm)
        if caches is not None:
            return hidden, new_caches
        return hidden


class LlamaForCausalLM(nn.Module):
    """The causal LM.  ``device=None`` means CUDA and raises
    ``RuntimeError`` without it; pass ``device="cpu"`` for the CPU, where
    every kernel runs its plain version.  Parameters are made in
    ``config.dtype`` on the device, drawn from a ``torch.Generator`` there
    seeded with ``seed``."""

    supports_static_kv_cache = True  # 3-tuple (k_buf, v_buf, pos) ring

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

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    def forward(self, input_ids, attn_mask=None, caches=None,
                qkv_weights=None):
        """input_ids [B, S] (a tensor on the model's device, or anything
        ``torch.as_tensor`` takes) -> logits [B, S, V] in the model's
        dtype, or (logits, new caches) when ``caches`` is given: per layer
        an empty or growing ``(k, v)`` [B, T, KVH, D], or the static ring
        ``(k_buf, v_buf, pos)``.  ``qkv_weights`` (``qkv_weights()``) spares
        a decode step its concatenations."""
        ids = torch.as_tensor(input_ids, device=self.device)
        out = self.llama(ids, attn_mask, caches, qkv_weights)
        hidden = out[0] if caches is not None else out
        logits = F.linear(hidden, self._head_weight())
        if caches is not None:
            return logits, out[1]
        return logits

    def qkv_weights(self, out=None):
        """Each layer's q/k/v weight concatenation (the decode step's
        ``qkv_fused`` weight), from the weights as they are; written into
        the tensors of ``out`` in place where given."""
        with torch.no_grad():
            return [layer.self_attn.qkv_weight(
                None if out is None else out[i])
                for i, layer in enumerate(self.llama.layers)]

    def _head_weight(self) -> torch.Tensor:
        if self.lm_head is None:
            return self.llama.embed_tokens.weight.t()
        return self.lm_head.weight

    def pretraining_loss(self, input_ids, labels=None, n_chunks: int = 8):
        """Shifted next-token loss through the chunked head: no [N, V]
        logits are kept (``_chunked_lm_loss``).  Equals
        ``LlamaPretrainingCriterion()(self(ids), ids)`` up to float32
        summation order."""
        ids = torch.as_tensor(input_ids, device=self.device)
        labels = ids if labels is None else torch.as_tensor(
            labels, device=self.device)
        hidden, w = amp_cast("fused_lm_loss", self.llama(ids),
                             self._head_weight())
        return _chunked_lm_loss(hidden, w, labels, n_chunks)

    @property
    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


class LlamaPretrainingCriterion(nn.Module):
    """Shifted next-token cross-entropy over logits [B, S, V] and labels
    [B, S] (the reference's, ``models/llama.py:554``)."""

    def __init__(self, config: Optional[LlamaConfig] = None):
        super().__init__()

    def forward(self, logits, labels):
        shift_logits = logits[:, :-1, :]
        shift_labels = labels[:, 1:]
        return F.cross_entropy(
            shift_logits.reshape(-1, shift_logits.shape[-1]),
            shift_labels.reshape(-1))


def _chunk_sum(h_c, w, y_c):
    """One chunk's (sum of -log p(label), count of labels >= 0): the GEMM
    on the operands' dtype (float32 accumulation), the softmax in
    float32."""
    logits = (h_c @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = y_c >= 0
    tgt = logits.gather(1, torch.clamp(y_c, min=0)[:, None])[:, 0]
    return torch.where(valid, lse - tgt, 0.0).sum(), valid.sum()


def _chunked_lm_loss(hidden, w, labels, n_chunks: int):
    """The reference's fused head + shifted cross-entropy: the tokens go
    through in ``n_chunks`` slices, each slice's logits live only inside a
    checkpointed chunk (rebuilt in the backward), so peak memory is
    O(N V / n_chunks).  Padding labels are -1."""
    B, S, H = hidden.shape
    sh = hidden[:, :-1, :].reshape(-1, H)
    sl = labels[:, 1:].reshape(-1).long()
    n = sh.shape[0]
    pad = (-n) % n_chunks
    if pad:
        sh = torch.cat([sh, sh.new_zeros((pad, H))])
        sl = torch.cat([sl, sl.new_full((pad,), -1)])
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for h_c, y_c in zip(sh.chunk(n_chunks), sl.chunk(n_chunks)):
        s, c = checkpoint(_chunk_sum, h_c, w, y_c, use_reentrant=False,
                          preserve_rng_state=False)
        tot, cnt = tot + s, cnt + c
    return tot / torch.clamp(cnt.float(), min=1.0)
