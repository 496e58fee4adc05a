"""The parameter-holding layers the Llama model needs, with paddle's layouts.

Counterparts: ``paddle_tpu/nn/layer/common.py`` ``Linear``/``Embedding``,
``nn/layer/norm.py`` ``RMSNorm``, and ``distributed/fleet/mp_layers.py``
Column/Row/VocabParallel layers at mp=1 (which hold the same parameters).
A ``Linear`` weight is ``[in, out]`` (``y = x @ W``), not torch's
``[out, in]``, so a paddle_tpu ``state_dict`` loads one for one.

These layers hold parameters only: the serving engine reads them and runs
its own forward (``inference/serving.py``).  Weights are drawn from an
explicit ``torch.Generator``, never from global random state.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["Linear", "Embedding", "RMSNorm"]


class Linear(nn.Module):
    """``weight [in, out]``, Xavier-uniform (paddle's default initializer);
    no bias (Llama's projections have none)."""

    def __init__(self, in_features: int, out_features: int, *,
                 device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        bound = math.sqrt(6.0 / (in_features + out_features))
        w = torch.empty(in_features, out_features, device=device, dtype=dtype)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w, requires_grad=False)


class Embedding(nn.Module):
    """``weight [num_embeddings, dim]`` ~ N(0, 1), as VocabParallelEmbedding
    initializes it."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 device: torch.device, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        w = torch.empty(num_embeddings, embedding_dim, device=device,
                        dtype=dtype)
        w.normal_(0.0, 1.0, generator=generator)
        self.weight = nn.Parameter(w, requires_grad=False)


class RMSNorm(nn.Module):
    """``weight [hidden]`` = ones; ``epsilon`` kept for the forward that
    reads it."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6, *,
                 device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype),
            requires_grad=False)
