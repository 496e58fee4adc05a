"""Datasets — the port of ``paddle_tpu/io/dataset.py``.

A dataset lives on the host: ``TensorDataset`` takes numpy arrays or CPU
tensors (a CUDA tensor is refused, since the DataLoader's forked workers
must not touch the card).  ``random_split`` draws its permutation from the
default generator's next key with the port's threefry, the indices of the
reference's ``jax.random.permutation`` for the same seed.
"""
from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np
import torch

from ..framework import random as prandom

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        for t in tensors:
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                raise ValueError("TensorDataset takes numpy arrays or CPU "
                                 f"tensors, got one on {t.device}: batches "
                                 "are made on the host and moved by the "
                                 "caller")
        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors)
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = datasets
        assert all(len(d) == len(datasets[0]) for d in datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets: List[IterableDataset]):
        self.datasets = datasets

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of the given lengths (or fractions) over a permutation drawn
    from ``generator``'s (default: the default generator's) next key."""
    if all(isinstance(n, float) for n in lengths):
        n = len(dataset)
        counts = [int(np.floor(n * frac)) for frac in lengths]
        rem = n - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    total = sum(lengths)
    assert total == len(dataset)
    key = (generator or prandom.default_generator()).next_key()
    perm = prandom.permutation(key, total).tolist()
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
        off += n
    return out
