"""Functionals — the port of ``paddle_tpu/nn/functional/flash_attention.py``
(``flash_attention``, ``scaled_dot_product_attention``) on paddle's
``[batch, seq, heads, head_dim]`` layout, of ``nn/functional/loss.py``'s
``cross_entropy`` (hard labels), of ``common.py``'s ``linear`` and of
``activation.py``'s ``relu`` and ``gelu``.

An unmasked attention call goes to the flash-attention kernels B1 forward /
B8 backward (``ops/hopper/flash_attention.py``, their plain versions for
CPU tensors); an explicit ``attn_mask`` goes to the plain masked attention
(``_ref_attention``, differentiable as plain torch), as in the reference,
where that path is jnp and no kernel.  Dropout needs a random stream and is
not on the ported paths: a dropout above 0 while training raises.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.hopper.flash_attention import flash_attention_fwd

__all__ = ["flash_attention", "scaled_dot_product_attention",
           "cross_entropy", "linear", "relu", "gelu"]


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)``, paddle's ``[in, out]`` weight; one
    ``torch.matmul``, as the reference leaves it to XLA."""
    out = x @ weight
    return out if bias is None else out + bias


def relu(x):
    return torch.relu(x)


def gelu(x, approximate: bool = False):
    """The exact erf form by default, the tanh form with ``approximate``
    (``jax.nn.gelu``'s two forms)."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def _ref_attention(q, k, v, *, causal: bool, scale: Optional[float],
                   mask: Optional[torch.Tensor] = None):
    """Reference attention on [B, S, H, D]: float32 scores and softmax,
    KV heads repeated for GQA, causal bottom-right, ``mask`` added to the
    scores; the probabilities are cast to q's dtype before P @ V."""
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
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return out.transpose(1, 2)


def _no_dropout(name, p, training):
    if training and float(p) > 0.0:
        raise NotImplementedError(
            f"{name}: dropout is not ported yet (it needs a random stream "
            "inside the kernel); pass dropout 0 or training=False")


def flash_attention(query, key, value, dropout: float = 0.0,
                    causal: bool = False, *, training: bool = True):
    """Flash attention on [B, S, H, D] -> (out, None).  The softmax is never
    materialised (the reference's documented divergence from paddle)."""
    _no_dropout("flash_attention", dropout, training)
    return flash_attention_fwd(query, key, value, causal=causal), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """paddle SDPA on [B, S, H, D]: unmasked -> kernel B1; with
    ``attn_mask`` (additive, broadcast to [B, H, Sq, Sk]) -> the plain
    masked attention."""
    _no_dropout("scaled_dot_product_attention", dropout_p, training)
    if attn_mask is not None:
        return _ref_attention(query, key, value, causal=is_causal,
                              scale=None, mask=attn_mask)
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
