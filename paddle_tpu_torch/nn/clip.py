"""Gradient clipping — the port of ``paddle_tpu/nn/clip.py``
(``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``,
``clip_grad_norm_``).

Each clip called on ``[(param, grad), ...]`` returns the clipped pairs, as
the reference's: a norm clip multiplies a gradient by its scale in float32
and rounds the product to the gradient's dtype (``(g * scale).astype(
g.dtype)``).  The optimizers take the clip through ``_factors``: the same
scales as float32 device tensors, one per pair (None where the gradient is
replaced instead, as ``ClipGradByValue`` clamps it), so that ``AdamW`` on
CUDA hands the scale to kernel B9, which multiplies and rounds in
registers, and no clipped copy of the gradients is written.  The norms are
taken in float32 (``torch._foreach_norm`` on CUDA, a pairwise sum of
squares on the CPU) and stay on the device: a clip needs no host sync.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]


def _scaled(g: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``(g * scale).astype(g.dtype)``: the product in float32, rounded
    once to g's dtype."""
    if scale is None:
        return g
    return (g.float() * scale).to(g.dtype)


def _norms(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's L2 norm, computed in float32: one ``_foreach_norm``
    on CUDA; on the CPU the square root of a sum of squares, which torch
    sums pairwise, as the reference does, where its CPU norm kernel
    accumulates in one pass (2e-4 of the norm off for a Llama lm_head's
    [256, 4096] gradient: Queue C14)."""
    if grads and grads[0].is_cuda:
        return list(torch._foreach_norm(grads, 2, dtype=torch.float32))
    return [torch.sqrt(torch.sum(torch.square(g.float()))) for g in grads]


class ClipGradBase:
    def __call__(self, params_grads):
        return [(p, g if g is None else _scaled(g, f))
                for p, g, f in self._factors(params_grads)]

    def _factors(self, params_grads) -> List[Tuple]:
        """``[(param, grad, scale)]``: the grad to use (the given one, or a
        replacement) and the float32 0-d device scale to apply to it, or
        None."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _factors(self, params_grads):
        return [(p, None if g is None else torch.clamp(g, self.min,
                                                       self.max), None)
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _factors(self, params_grads):
        live = [g for _, g in params_grads if g is not None]
        norms = iter(_norms(live) if live else ())
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g, None))
                continue
            n = next(norms)
            out.append((p, g, torch.clamp(
                self.clip_norm / torch.clamp(n, min=1e-12), max=1.0)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        # optional cross-shard reduction hook: fn(sq_sum) -> sq_sum
        self.global_norm_reduce = None

    def _factors(self, params_grads):
        summed = [g for p, g in params_grads
                  if g is not None and getattr(p, "requires_grad", True)]
        if not summed:
            return [(p, g, None) for p, g in params_grads]
        sq = torch.stack(_norms(summed)).square().sum()
        if self.global_norm_reduce is not None:
            sq = self.global_norm_reduce(sq)
        gn = torch.sqrt(sq)
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(p, g, None if g is None else scale)
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Clip the gradients of ``parameters`` in place to a total norm of
    ``max_norm`` (``norm_type`` p, or ``inf``: the largest |g|, taken in the
    gradients' dtype); returns the total norm, a device tensor."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.stack([g.abs().max() for g in grads]).max()
        else:
            total = torch.pow(
                sum(torch.sum(torch.pow(torch.abs(g.float()), norm_type))
                    for g in grads), 1.0 / norm_type)
        # max_norm / max(total, 1e-6), at most 1, in total's dtype (the
        # reference's weak-typed scalars take it)
        scale = torch.clamp(
            torch.full((), max_norm, dtype=total.dtype, device=total.device)
            / torch.clamp(total, min=1e-6), max=1.0)
        for p in parameters:
            if p.grad is not None:
                p.grad.copy_(_scaled(p.grad, scale))
    return total
