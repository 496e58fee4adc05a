"""Seeded random draws, bit for bit those of JAX's threefry key chain — the
port of ``paddle_tpu/framework/random.py`` and of the parts of
``jax.random`` it stands on.

A key is an int64 tensor ``[..., 2]`` holding the two 32-bit words of a
raw threefry key (the leading dimensions are a batch of keys, what the
reference gets with ``vmap``).  Every word is kept in an int64 masked to
32 bits, so additions, rotations and xors are exact on the CPU and on the
card alike.  What each function computes, in ``jax/_src``:

- ``key(seed)``: ``prng.threefry_seed`` with 64-bit types off (JAX's
  default): the seed as a 32-bit integer, ``(0, seed & 0xFFFFFFFF)``;
- ``fold_in(key, data)``: ``prng.threefry_fold_in`` — the threefry2x32
  hash of the counter pair ``(0, data)`` under ``key``;
- ``random_bits(key, shape)``: ``prng._threefry_random_bits_partitionable``
  (``jax_threefry_partitionable``, on by default) — the hash of the 64-bit
  iota ``(i >> 32, i & 0xFFFFFFFF)`` over the flattened shape, the two
  output words xored;
- ``uniform``: ``random._uniform`` for float32 — 23 random mantissa bits
  under the exponent of 1.0, minus 1, scaled and clamped to ``minval``;
- ``gumbel``: ``random._gumbel`` in mode ``"low"`` — ``-log(-log(u))``,
  u uniform in ``[tiny, 1)``;
- ``categorical``: ``random.categorical`` with replacement — the argmax of
  ``gumbel + logits`` over the last axis.

- ``bernoulli``: ``random.bernoulli`` in mode ``"low"`` —
  ``uniform(key, shape) < p``, p rounded to float32.
- ``split(key, num)``: ``prng._threefry_split_foldlike`` — the hash of the
  counter pairs ``(0, i)``, so ``split(key)[i] == fold_in(key, i)``;
- ``permutation(key, n)``: ``random._shuffle`` over ``arange(n)`` —
  ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each splitting the key, drawing
  32-bit sort keys from the subkey and sorting stably by them.

``Generator(seed).next_key()`` is ``fold_in(key(seed), counter)`` after
``counter += 1``, as the reference's; inside a ``TrainStep`` (an active
``jit.trace_state.TraceContext``) it is the step's ``fold_in(base, i)``
instead, as the reference's inside a trace.  The process-wide
``default_generator()`` (seeded by ``seed``) is the stream dropout draws
from, as in the reference; sampling takes an explicit ``Generator``.
A key for an integer seed or counter is made on its device by a fill, never
by a host-to-device copy, so drawing needs no host sync.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

__all__ = ["key", "fold_in", "split", "random_bits", "uniform", "gumbel",
           "categorical", "bernoulli", "permutation", "Generator", "seed",
           "default_generator", "get_rng_state", "set_rng_state"]

_M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny

Seed = Union[int, torch.Tensor]


def _word(x: Seed, device) -> torch.Tensor:
    """A 32-bit word (or a tensor of them) as int64 on ``device``: a Python
    integer is written there by a fill, so no host-to-device copy (a host
    sync) is made; a tensor is moved as it is."""
    if isinstance(x, int):
        return torch.full((), x & _M32, dtype=torch.int64, device=device)
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _M32


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (``prng._threefry2x32_lowering``) on
    broadcastable int64 tensors holding 32-bit words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) & _M32) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def key(seed: Seed, device=None) -> torch.Tensor:
    """Raw threefry key(s) from an integer seed or an integer tensor of
    seeds: ``[..., 2]`` int64 on ``device`` (the seed tensor's device when
    a tensor is given)."""
    s = _word(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k: torch.Tensor, data: Seed) -> torch.Tensor:
    """A new key from ``k`` [..., 2] and a 32-bit integer (or an integer
    tensor broadcasting against ``k``'s batch)."""
    d = _word(data, k.device)
    y1, y2 = _threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys ``[num, 2]`` from one key ``k`` [2]."""
    i = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = _threefry2x32(k[0], k[1], torch.zeros_like(i), i)
    return torch.stack([y1, y2], dim=-1)


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element: int64 tensor ``k.shape[:-1] + shape``
    with values in [0, 2**32)."""
    shape = tuple(int(n) for n in shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    batch = k.shape[:-1]
    lead = (slice(None),) * len(batch) + (None,) * len(shape)
    y1, y2 = _threefry2x32(k[..., 0][lead], k[..., 1][lead], idx >> 32,
                           idx & _M32)
    return y1 ^ y2


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)``, ``k.shape[:-1] + shape``."""
    bits = (random_bits(k, shape) >> 9) | _F32_ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # the bounds as float32 scalars, their difference rounded in float32
    # (no device tensor is made: a host-to-device copy would sync); XLA
    # fuses floats * span + lo into one multiply-add, rounded once: the
    # float32 product is exact in float64
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32)
                 - torch.tensor(lo, dtype=torch.float32))
    return torch.clamp((floats.double() * span + lo).float(), min=lo)


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """float32 standard Gumbel noise, ``k.shape[:-1] + shape``."""
    return -torch.log(-torch.log(uniform(k, shape, _F32_TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` [..., V] (float32) with the key of
    that row, ``k`` [..., 2]: int64 indices ``logits.shape[:-1]``."""
    g = gumbel(k, logits.shape[-1:])
    return torch.argmax(g + logits, dim=-1)


def bernoulli(k: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """Booleans, True with probability ``p``: ``uniform(k, shape) < p``
    with ``p`` rounded to float32, ``jax.random.bernoulli``'s "low" mode
    for a float ``p``."""
    p32 = float(np.float32(p))
    return uniform(k, shape) < p32


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: a permutation of ``range(n)``,
    int64 on ``k``'s device."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


class Generator:
    """A seeded stream of keys: ``next_key()`` advances the counter and
    returns ``fold_in(key(seed), counter)``, as
    ``paddle_tpu.framework.random.Generator.next_key`` does outside a
    trace.  Keys live on the CPU unless ``device`` is given."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._counter = 0

    def manual_seed(self, seed: int) -> "Generator":
        self._seed = int(seed)
        self._counter = 0
        return self

    def next_key(self, device=None) -> torch.Tensor:
        """A fresh key; advances the stream.  Inside a ``TrainStep`` the
        key comes from the step's context (``fold_in(base, i)`` on the
        base key's device), as the reference's does inside a trace."""
        from ..jit import trace_state

        ctx = trace_state.current()
        if ctx is not None:
            return ctx.next_key()
        self._counter += 1
        return fold_in(key(self._seed, device), self._counter)

    def get_state(self):
        return (self._seed, self._counter)

    def set_state(self, state) -> "Generator":
        self._seed, self._counter = int(state[0]), int(state[1])
        return self


_default_generator = Generator(0)


def default_generator() -> Generator:
    """The process-wide stream that dropout draws from."""
    return _default_generator


def seed(s: int) -> Generator:
    """``paddle.seed``: reseed the default generator (counter 0)."""
    return _default_generator.manual_seed(s)


def get_rng_state():
    return _default_generator.get_state()


def set_rng_state(state):
    _default_generator.set_state(state)
