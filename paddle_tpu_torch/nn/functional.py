"""Functionals — the port of ``paddle_tpu/nn/functional/flash_attention.py``
(``flash_attention``, ``scaled_dot_product_attention``) on paddle's
``[batch, seq, heads, head_dim]`` layout, of ``nn/functional/loss.py``'s
``cross_entropy`` (hard labels), of ``common.py``'s ``linear``,
``dropout``, ``dropout2d``, ``dropout3d`` and ``alpha_dropout`` (``:32-79``)
and of ``activation.py``'s ``relu`` and ``gelu``.

An unmasked attention call without dropout goes to the flash-attention
kernels B1 forward / B8 backward (``ops/hopper/flash_attention.py``, their
plain versions for CPU tensors); an explicit ``attn_mask``, or a dropout
above 0 while training, goes to the plain attention (``_ref_attention``,
differentiable as plain torch), as in the reference, where that path is
jnp and no kernel (its Pallas kernel, too, runs only at dropout 0).

Dropout draws its keep mask from ``framework.random``'s default generator
(inside a ``TrainStep``, the step's key chain): ``bernoulli(key, 1 - p,
shape)``, JAX's bits exactly, then ``where(keep, x / (1 - p), 0)`` in x's
dtype, the scale rounded to x's dtype as JAX's weak-typed scalar is.

Each op casts its inputs for AMP under its reference tag
(``amp.amp_cast``): ``linear``, ``flash_attention`` and ``sdpa`` are on
the white list, ``cross_entropy`` on the black list, ``dropout`` and
``gelu`` on neither.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..amp.auto_cast import amp_cast
from ..framework.random import bernoulli, default_generator
from ..ops.hopper.flash_attention import flash_attention_fwd

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "cross_entropy", "linear", "relu", "gelu", "dropout", "dropout2d",
           "dropout3d", "alpha_dropout"]


def _matmul(x, w):
    """``x @ w`` under jnp's promotion: two float dtypes meet at the wider
    (bfloat16 by float32 is a float32 product), where ``torch.matmul``
    takes one dtype only."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)``, paddle's ``[in, out]`` weight; one
    ``torch.matmul``, as the reference leaves it to XLA.  Mixed dtypes
    promote as jnp's, the product first, then the bias add."""
    if bias is None:
        x, weight = amp_cast("linear", x, weight)
        return _matmul(x, weight)
    x, weight, bias = amp_cast("linear", x, weight, bias)
    return _matmul(x, weight) + bias


def relu(x):
    return torch.relu(x)


def gelu(x, approximate: bool = False):
    """The exact erf form by default, the tanh form with ``approximate``
    (``jax.nn.gelu``'s two forms)."""
    (x,) = amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def _in_dtype(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype, as JAX rounds a weak-typed
    Python scalar before an op on ``like``: PyTorch would take the scalar
    at float32."""
    return float(torch.tensor(value, dtype=like.dtype))


def _drop(x, keep, p: float):
    """``where(keep, x / (1 - p), 0)`` in x's dtype."""
    return torch.where(keep, x / _in_dtype(1.0 - p, x), 0.0)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Zero each element (or each slice along the axes not in ``axis``)
    with probability ``p``; ``upscale_in_train`` scales the kept ones by
    1 / (1 - p), ``downscale_in_infer`` leaves them.  The identity in eval
    or at p == 0."""
    if not training or p == 0:
        return x
    if isinstance(p, torch.Tensor):
        p = float(p)
    key = default_generator().next_key(device=x.device)
    (x,) = amp_cast("dropout", x)
    if axis is None:
        mask_shape = tuple(x.shape)
    else:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        kept = [a % x.dim() for a in axes]
        mask_shape = tuple(x.shape[i] if i in kept else 1
                           for i in range(x.dim()))
    keep = bernoulli(key, 1.0 - p, mask_shape)
    if mode == "upscale_in_train":
        return _drop(x, keep, p)
    return torch.where(keep, x, 0.0)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True):
    """SELU-preserving dropout: dropped elements take alpha', then an
    affine map keeps the mean and variance."""
    if not training or p == 0:
        return x
    key = default_generator().next_key(device=x.device)
    (x,) = amp_cast("alpha_dropout", x)
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = bernoulli(key, 1.0 - p, x.shape)
    a = (1.0 - p + p * alpha_p ** 2) ** -0.5
    b = -a * p * alpha_p
    return (torch.where(keep, x, _in_dtype(alpha_p, x)) * _in_dtype(a, x)
            + _in_dtype(b, x))


def _ref_attention(q, k, v, *, causal: bool, scale: Optional[float],
                   mask: Optional[torch.Tensor] = None, dropout: float = 0.0,
                   dropout_key: Optional[torch.Tensor] = None):
    """Reference attention on [B, S, H, D]: float32 scores and softmax,
    KV heads repeated for GQA, causal bottom-right, ``mask`` added to the
    scores; the probabilities are cast to q's dtype before P @ V, and with
    ``dropout`` above 0 dropped by ``bernoulli(dropout_key, 1 - dropout)``
    over [B, H, Sq, Sk] and the kept ones scaled by 1 / (1 - dropout) in
    q's dtype."""
    B, Sq, H, D = q.shape
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    if k.shape[2] != H:
        rep = H // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D]
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh).float() * sc
    if causal:
        Sk = kh.shape[2]
        cm = torch.ones((Sq, Sk), dtype=torch.bool,
                        device=q.device).tril(diagonal=Sk - Sq)
        logits = torch.where(cm, logits, -1e30)
    if mask is not None:
        logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout > 0.0 and dropout_key is not None:
        p = _drop(p, bernoulli(dropout_key, 1.0 - dropout, p.shape), dropout)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return out.transpose(1, 2)


def _drop_key(p: float, training: bool, like: torch.Tensor):
    """(the dropout rate in force, its key or None): the key is drawn
    before the op runs, as the reference draws it before its dispatch."""
    drop = float(p) if training else 0.0
    key = (default_generator().next_key(device=like.device)
           if drop > 0.0 else None)
    return drop, key


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, *, training: bool = True):
    """Flash attention on [B, S, H, D] -> (out, None).  The softmax is never
    materialised (the reference's documented divergence from paddle).  A
    dropout above 0 while training takes the plain attention with the
    step's mask, as the reference's."""
    drop, dkey = _drop_key(dropout, training, query)
    query, key, value = amp_cast("flash_attention", query, key, value)
    if drop > 0.0:
        return _ref_attention(query, key, value, causal=causal, scale=None,
                              dropout=drop, dropout_key=dkey), None
    return flash_attention_fwd(query, key, value, causal=causal), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """paddle SDPA on [B, S, H, D]: unmasked without dropout -> kernel B1;
    with ``attn_mask`` (additive, broadcast to [B, H, Sq, Sk]) or a dropout
    above 0 while training -> the plain attention."""
    drop, dkey = _drop_key(dropout_p, training, query)
    if attn_mask is not None:
        query, key, value, attn_mask = amp_cast("sdpa", query, key, value,
                                                attn_mask)
        return _ref_attention(query, key, value, causal=is_causal,
                              scale=None, mask=attn_mask, dropout=drop,
                              dropout_key=dkey)
    query, key, value = amp_cast("sdpa", query, key, value)
    if drop > 0.0:
        return _ref_attention(query, key, value, causal=is_causal,
                              scale=None, dropout=drop, dropout_key=dkey)
    return flash_attention_fwd(query, key, value, causal=is_causal)


def cross_entropy(input, label, ignore_index: int = -100,  # noqa: A002
                  reduction: str = "mean"):
    """paddle's ``cross_entropy`` with hard labels (``loss.py:28-79``):
    input [..., C] logits, label [...] (or [..., 1]) class ids.  The
    log-softmax is taken in the logits' dtype, as ``jax.nn.log_softmax``
    is; labels equal to ``ignore_index`` contribute 0 and leave the mean's
    count.  ``reduction`` is "mean" (over the counted labels, at least
    1), "sum" or "none".  Class weights, soft labels and label smoothing
    are not ported."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    (input,) = amp_cast("cross_entropy", input)  # noqa: A001
    logp = torch.log_softmax(input, dim=-1)
    lab = label.long()
    if lab.dim() == logp.dim():          # paddle allows a trailing 1
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    per = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    per = per.masked_fill(~valid, 0.0)
    if reduction == "mean":
        return per.sum() / valid.sum().to(per.dtype).clamp(min=1.0)
    if reduction == "sum":
        return per.sum()
    return per
