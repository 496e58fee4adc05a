"""Transformer encoder layers — the port of
``paddle_tpu/nn/layer/transformer.py`` (``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``).

``MultiHeadAttention`` keeps paddle's separate q/k/v/out projections (each
a ``Linear`` with a bias, so the weight-only int8 rewrite of
``inference.Predictor`` reaches them) and its caches, and attends through
``nn.functional.scaled_dot_product_attention`` on ``[B, S, H, D]``:
unmasked and without dropout, that is kernel B1; with an additive
``attn_mask``, or its dropout while training, the plain attention, as in
the reference.  Sub-module names equal the reference's, so its
``state_dict`` loads one for one.

The layers take ``device=None`` (CUDA, or ``RuntimeError`` without it),
``dtype`` and an explicit ``torch.Generator`` as keywords.  Dropout is the
identity in eval; while training each layer draws its masks in the
reference's order (the attention's, ``dropout1``, ``act_dropout``,
``dropout2``) from the default generator, or from the step's keys inside a
``TrainStep``.  The residual adds cast as the reference's "add" under AMP.
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
           "TransformerEncoder"]


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 kdim: Optional[int] = None, vdim: Optional[int] = None, *,
                 bias_attr: Optional[bool] = None, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        kw = dict(bias_attr=bias_attr, device=resolve_device(device),
                  dtype=dtype, generator=generator)
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
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
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


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, activation: str = "relu",
                 attn_dropout: Optional[float] = None,
                 act_dropout: Optional[float] = None,
                 normalize_before: bool = False, *,
                 bias_attr: Optional[bool] = None,
                 layer_norm_eps: float = 1e-5, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(bias_attr=bias_attr, device=dev, dtype=dtype,
                  generator=generator)
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
