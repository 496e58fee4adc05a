"""Search ops — the port of ``top_p_sampling`` from
``paddle_tpu/tensor/search.py``, as ``generate(do_sample=True)`` calls it.

Plain PyTorch on the probabilities' device: a stable descending sort, the
nucleus cut (truncated: the kept mass is exactly top-p), and an
inverse-CDF draw from one float32 uniform per row.  The uniforms are JAX's
(``framework/random.py``), drawn under a key from the caller's explicit
``Generator`` (there is no global one), so the same seed gives the
reference's tokens.  The reference's other modes (a probability
threshold, per-row or fixed seeds, non-truncated cuts, the top-k return)
have no caller in the port and are not ported.
"""
from __future__ import annotations

import torch

from ..framework.random import Generator, uniform

__all__ = ["top_p_sampling"]


def top_p_sampling(x: torch.Tensor, ps: torch.Tensor, generator: Generator):
    """x [B, V] probabilities; ps [B] per-row top-p -> (value, index) of
    one sampled token per row, [B, 1] each (index int64).  Draws
    ``uniform(generator.next_key(), (B, 1))``."""
    B, V = x.shape
    probs = x.float()
    order = torch.argsort(-probs, dim=-1, stable=True)
    sp = probs.gather(-1, order)                          # sorted desc
    csum = torch.cumsum(sp, dim=-1)
    p_col = ps.reshape(-1, 1).float()
    # truncated nucleus: tokens whose preceding cumulative mass is below p,
    # the boundary token clipped so the kept mass is exactly p (the argmax
    # token always stays)
    sp_kept = torch.minimum(torch.clamp(p_col - (csum - sp), min=0.0), sp)
    total = torch.clamp(sp_kept.sum(-1, keepdim=True), min=1e-30)
    u = uniform(generator.next_key(x.device), (B, 1)) * total
    # inverse CDF over the kept mass
    ccum = torch.cumsum(sp_kept, dim=-1)
    pos = (ccum < u).sum(-1, keepdim=True).clamp(0, V - 1)
    idx = order.gather(-1, pos)
    return x.gather(-1, idx), idx
