"""Transformer layers — the port of ``paddle_tpu/nn/layer/transformer.py``
(``MultiHeadAttention``, ``TransformerEncoderLayer``, ``TransformerEncoder``,
``TransformerDecoderLayer``, ``TransformerDecoder``, ``Transformer``).

``MultiHeadAttention`` keeps paddle's separate q/k/v/out projections (each
a ``Linear`` with a bias, so the weight-only int8 rewrite of
``inference.Predictor`` reaches them) and its caches, and attends through
``nn.functional.scaled_dot_product_attention`` on ``[B, S, H, D]``:
unmasked and without dropout, that is kernel B1 (non-causal: a cached
decode step's one query over the ``Cache`` or the ``StaticCache`` of the
encoder's memory too); with an additive ``attn_mask``, or its dropout
while training, the plain attention, as in the reference.  Sub-module
names equal the reference's, so its ``state_dict`` loads one for one.
``need_weights`` is kept and, as in the reference, changes nothing (the
attention weights are never returned).

The decoder layer runs self-attention (an incremental ``Cache`` when
given one), cross-attention over ``memory`` (a ``StaticCache`` of its
projected keys and values when given one: that call returns no tuple)
and the feed-forward, each with its residual and norm before
(``normalize_before``) or after; a cached call returns ``(out,
(new_cache, static_cache))``.  ``TransformerDecoder`` stacks deep copies
of one layer (every layer starts from the same weights, as in the
reference); ``gen_cache(memory, do_zip)`` makes every layer's pair.
``Transformer`` is the encoder-decoder with a final ``LayerNorm`` on each
side only under ``normalize_before``.

The layers take ``device=None`` (CUDA, or ``RuntimeError`` without it),
``dtype`` and an explicit ``torch.Generator`` as keywords, and the
reference's ``weight_attr`` / ``bias_attr`` (``nn._check_attr``: one that
carries an initializer raises, ROADMAP A10).  Dropout is the identity in
eval; while training each layer draws its masks in the reference's order
(the encoder: the attention's, ``dropout1``, ``act_dropout``,
``dropout2``; the decoder: self-attention's, ``dropout1``,
cross-attention's, ``dropout2``, ``act_dropout``, ``dropout3``) from the
default generator, or from the step's keys inside a ``TrainStep``.  The
residual adds cast as the reference's "add" under AMP, a cache's growth
as its "concat".
"""
from __future__ import annotations

import collections
import copy
from typing import Optional

import torch
from torch import nn

from ..amp.auto_cast import amp_cast
from ..device import resolve_device
from . import Dropout, LayerNorm, Linear
from . import functional as F

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None,
                 need_weights: bool = False, weight_attr=None,
                 bias_attr=None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                  device=resolve_device(device), dtype=dtype,
                  generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        """[B, S, E] -> [B, S, H, D]"""
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """``StaticCache``: the projected keys and values of ``key`` /
        ``value`` (cross-attention memory); otherwise an empty ``Cache``
        [B, 0, H, D] that each call extends."""
        if type == MultiHeadAttention.StaticCache:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        z = torch.zeros((key.shape[0], 0, self.num_heads, self.head_dim),
                        dtype=key.dtype, device=key.device)
        return self.Cache(z, z)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._shape(self.k_proj(key))
            v = self._shape(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = _concat(cache.k, k)
                v = _concat(cache.v, v)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None and not isinstance(cache, self.StaticCache):
            return out, cache
        return out


_ACT = {"relu": F.relu, "gelu": F.gelu}


def _add(a, b):
    """The reference's "add" op, cast as AMP casts it."""
    a, b = amp_cast("add", a, b)
    return a + b


def _concat(cache, new):
    """A growing cache's ``concat`` along the sequence (dim 1), cast as AMP
    casts the reference's "concat" op; two float dtypes promote, as
    ``jnp.concatenate`` does."""
    cache, new = amp_cast("concat", cache, new)
    return torch.cat([cache, new], dim=1)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, layer_norm_eps: float = 1e-5, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=dev,
                  dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            attn_dropout if attn_dropout is not None else dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=dev,
                               dtype=dtype)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=dev,
                               dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = _ACT[activation]

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is not None:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        else:
            src = self.self_attn(src, src, src, src_mask)
        src = _add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = _add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the given
    layer, the rest deep copies with its weights), then ``norm`` if any."""

    def __init__(self, encoder_layer: TransformerEncoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is not None:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
            else:
                output = layer(output, src_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, layer_norm_eps: float = 1e-5, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, device=dev,
                  dtype=dtype, generator=generator)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, device=dev,
                               dtype=dtype)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, device=dev,
                               dtype=dtype)
        self.norm3 = LayerNorm(d_model, layer_norm_eps, device=dev,
                               dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout if act_dropout is not None
                                   else dropout)
        self.activation = _ACT[activation]

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """``cache``: (``Cache`` of the self-attention, ``StaticCache`` of
        the memory), as ``gen_cache`` makes it -> (out, (new Cache, the
        StaticCache)); without it -> out."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, new_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                            cache[0])
        tgt = _add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                                  cache[1])
            if isinstance(tgt, tuple):      # a growing Cache for the memory
                tgt = tgt[0]
        tgt = _add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = _add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (new_cache, cache[1]))

    def gen_cache(self, memory):
        """(an empty self-attention ``Cache`` [B, 0, H, D] in memory's
        dtype, the cross-attention's ``StaticCache`` of memory)."""
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(nn.Module):
    """``num_layers`` copies of ``decoder_layer`` (the first is the given
    layer, the rest deep copies with its weights), then ``norm`` if any."""

    def __init__(self, decoder_layer: TransformerDecoderLayer,
                 num_layers: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip: bool = False):
        """Every layer's (Cache, StaticCache); ``do_zip``: the pairs
        transposed, (all the Caches, all the StaticCaches)."""
        caches = [layer.gen_cache(memory) for layer in self.layers]
        if do_zip:
            caches = list(zip(*caches))
        return caches


class Transformer(nn.Module):
    """The encoder-decoder (``transformer.py:236-272``): ``custom_encoder``
    / ``custom_decoder`` replace a side; otherwise each side is
    ``num_*_layers`` copies of one layer, with a final ``LayerNorm`` only
    under ``normalize_before``."""

    def __init__(self, d_model: int = 512, nhead: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, weight_attr=None,
                 bias_attr=None, custom_encoder: Optional[nn.Module] = None,
                 custom_decoder: Optional[nn.Module] = None, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        dev = resolve_device(device)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        kw = dict(device=dev, dtype=dtype, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_norm = (LayerNorm(d_model, device=dev, dtype=dtype)
                        if normalize_before else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_norm = (LayerNorm(d_model, device=dev, dtype=dtype)
                        if normalize_before else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length: int, device=None
                                        ) -> torch.Tensor:
        """[length, length] float32: 0 on and below the diagonal, -1e9
        above it (an additive causal mask), on ``device`` (the card by
        default)."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, -1e9).to(torch.float32)
