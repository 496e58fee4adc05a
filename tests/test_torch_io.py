"""The port's data loading (``paddle_tpu_torch/io``, ``native``) against the
JAX package's ``paddle_tpu.io``, on the CPU.

- ``DataLoader`` over the same numpy samples: batches with
  ``num_workers`` 0 and 2 (forked workers over the shared-memory ring
  built from the port's ``native/shm_queue.cpp``) equal the reference's
  in-process batches exactly (``shuffle=False``), for tuples, dicts and a
  custom ``collate_fn``, with ``drop_last``; ``get_worker_info`` and
  ``worker_init_fn`` inside the workers; an ``IterableDataset``; a
  worker's error raised in the parent with its traceback; a batch the
  ring does not encode (bfloat16) crossing pickled.  The port's int64
  batches stay int64 where the reference's JAX, without 64-bit types,
  makes them int32.
- ``random_split``: the reference's indices for the same seed (JAX's
  ``permutation``, rebuilt from the port's threefry) at sizes that take
  one and two sort rounds, by lengths and by fractions.
- The samplers: ``DistributedBatchSampler`` by epoch and rank, and the
  others' batches and lengths.
- The ring's library: built by g++ into ``build/paddle_tpu_torch``, a
  push/pop round trip, and a compile error raised with the compiler's
  message.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import native
from paddle_tpu_torch.framework import random as prand

torch.set_num_threads(2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x._value if hasattr(x, "_value") else x)


def _same(a, b):
    """Nested batches equal exactly (the port's tensors against the
    reference's)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        # a number from a collate_fn stays a number in process, and crosses
        # the ring as a 0-d array, as in the reference
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cpu"
        x, y = _np(a), _np(b)
        # the reference's JAX runs without 64-bit types: its int64 batches
        # are int32 arrays
        if not (x.dtype == np.int64 and y.dtype == np.int32):
            assert x.dtype == y.dtype
        assert np.array_equal(x, y)


def _arrays(n=37):
    rng = np.random.default_rng(5)
    return (rng.standard_normal((n, 3, 4)).astype(np.float32),
            rng.integers(0, 9, (n,)).astype(np.int64))


class _Dicts:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return {"x": self.x[i], "y": int(self.y[i]), "w": float(i) / 3}


def _pair_of(kind):
    x, y = _arrays()
    if kind == "tensor":
        return pio.TensorDataset([x, y]), P.io.TensorDataset([x, y])
    if kind == "dict":
        d = _Dicts(x, y)
        return d, d
    return (pio.ConcatDataset([pio.TensorDataset([x[:20], y[:20]]),
                               pio.Subset(pio.TensorDataset([x, y]),
                                          range(20, 37))]),
            P.io.ConcatDataset([P.io.TensorDataset([x[:20], y[:20]]),
                                P.io.Subset(P.io.TensorDataset([x, y]),
                                            range(20, 37))]))


def _collate(batch):
    return [np.stack([s[0] for s in batch]).sum(0),
            np.asarray([s[1] for s in batch]).max()]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kind,drop_last,collate", [
    ("tensor", False, None), ("tensor", True, None), ("dict", False, None),
    ("concat", False, None), ("tensor", False, _collate)])
def test_batches_equal_the_reference(kind, drop_last, collate, workers):
    ours, ref = _pair_of(kind)
    got = list(pio.DataLoader(ours, batch_size=5, shuffle=False,
                              drop_last=drop_last, collate_fn=collate,
                              num_workers=workers))
    want = list(P.io.DataLoader(ref, batch_size=5, shuffle=False,
                                drop_last=drop_last, collate_fn=collate))
    assert len(got) == len(want) == (7 if drop_last else 8)
    for a, b in zip(got, want):
        _same(a, b)


class _WhoAmI(pio.Dataset):
    """Each sample carries the id of the worker that read it and a value
    its ``worker_init_fn`` set."""

    mark = 0

    def __len__(self):
        return 12

    def __getitem__(self, i):
        info = pio.get_worker_info()
        return np.asarray([i, info.id, info.num_workers, _WhoAmI.mark,
                           info.dataset is self])


def _init(wid):
    _WhoAmI.mark = 100 + wid


def test_worker_info_and_init_fn():
    assert pio.get_worker_info() is None
    ds = _WhoAmI()
    rows = torch.cat(list(pio.DataLoader(ds, batch_size=2, num_workers=2,
                                         worker_init_fn=_init)))
    assert rows[:, 0].tolist() == list(range(12))
    assert set(rows[:, 1].tolist()) <= {0, 1}
    assert rows[:, 2].tolist() == [2] * 12
    assert rows[:, 3].tolist() == [100 + w for w in rows[:, 1].tolist()]
    assert rows[:, 4].tolist() == [1] * 12
    assert _WhoAmI.mark == 0 and pio.get_worker_info() is None


class _Stream(pio.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.full((2,), i, np.int64), float(i) / 2


class _JaxStream(P.io.IterableDataset):
    def __iter__(self):
        return iter(_Stream())


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_equals_the_reference(drop_last):
    got = list(pio.DataLoader(_Stream(), batch_size=4, drop_last=drop_last))
    want = list(P.io.DataLoader(_JaxStream(), batch_size=4,
                                drop_last=drop_last))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for a, b in zip(got, want):
        _same(a, b)
    with pytest.raises(TypeError):
        len(pio.DataLoader(_Stream()))


class _Faulty(pio.Dataset):
    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i == 7:
            raise KeyError(f"no sample {i}")
        return np.ones(2, np.float32)


@pytest.mark.parametrize("workers", [0, 2])
def test_a_worker_error_is_raised_in_the_parent(workers):
    it = iter(pio.DataLoader(_Faulty(), batch_size=2, num_workers=workers))
    for _ in range(3):
        assert next(it).shape == (2, 2)
    with pytest.raises((RuntimeError, KeyError), match="no sample 7") as e:
        next(it)
    if workers:
        assert "DataLoader worker" in str(e.value)
        assert "Traceback" in str(e.value)


class _Bf16(pio.Dataset):
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return torch.full((3,), i / 7, dtype=torch.bfloat16), i


def test_a_batch_the_ring_does_not_encode_crosses_pickled():
    got = list(pio.DataLoader(_Bf16(), batch_size=4, num_workers=2))
    want = list(pio.DataLoader(_Bf16(), batch_size=4))
    for (a, ya), (b, yb) in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        assert torch.equal(ya, yb)


def test_tensor_dataset_refuses_a_device_tensor():
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="host"):
        pio.TensorDataset([meta])


@pytest.mark.parametrize("n,lengths", [
    (10, [3, 7]), (100, [0.5, 0.3, 0.2]), (1000, [600, 400]),
    (2000, [1000, 999, 1]), (1626, [0.25, 0.75])])
def test_random_split_equals_the_reference(n, lengths):
    """``ceil(3 ln n / ln(2**32 - 1))`` sort rounds: one up to n = 1625,
    two from 1626."""
    for seed in (0, 7):
        P.seed(seed)
        prand.seed(seed)
        data = list(range(n))
        ours = pio.random_split(data, lengths)
        ref = P.io.random_split(data, lengths)
        assert [s.indices for s in ours] == [list(s.indices) for s in ref]
        # the next draw from the same stream agrees too
        ours = pio.random_split(data, lengths)
        ref = P.io.random_split(data, lengths)
        assert [s.indices for s in ours] == [list(s.indices) for s in ref]
    gen = prand.Generator(3)
    P.seed(3)
    assert pio.random_split(data, lengths, generator=gen)[0].indices == \
        list(P.io.random_split(data, lengths)[0].indices)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_distributed_batch_sampler_equals_the_reference(shuffle, drop_last):
    data = list(range(23))
    for rank in range(3):
        ours = pio.DistributedBatchSampler(data, 4, num_replicas=3,
                                           rank=rank, shuffle=shuffle,
                                           drop_last=drop_last)
        ref = P.io.DistributedBatchSampler(data, 4, num_replicas=3,
                                           rank=rank, shuffle=shuffle,
                                           drop_last=drop_last)
        for epoch in (0, 1, 5):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref)
            assert len(ours) == len(ref)
    one = pio.DistributedBatchSampler(data, 4)
    assert (one.nranks, one.local_rank) == (1, 0)


def test_the_other_samplers():
    data = list(range(10))
    assert list(pio.SequenceSampler(data)) == data
    for drop_last in (False, True):
        bs = pio.BatchSampler(data, batch_size=4, drop_last=drop_last)
        ref = P.io.BatchSampler(data, batch_size=4, drop_last=drop_last)
        assert list(bs) == list(ref) and len(bs) == len(ref)
    assert sorted(pio.RandomSampler(data)) == data
    assert len(list(pio.RandomSampler(data, replacement=True,
                                      num_samples=25))) == 25
    assert sorted(pio.SubsetRandomSampler([2, 4, 6])) == [2, 4, 6]
    w = list(pio.WeightedRandomSampler([0.0, 1.0, 0.0], 7))
    assert w == [1] * 7
    shuffled = list(pio.BatchSampler(data, shuffle=True, batch_size=3))
    assert sorted(sum(shuffled, [])) == data


def test_the_ring_builds_and_carries_batches():
    path = native.build()
    assert path == native.LIB_PATH and os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "paddle_tpu_torch"
    q = native.ShmQueue(f"/ptt_test_{os.getpid()}", slot_size=1 << 12,
                        n_slots=2)
    try:
        arrays = [np.arange(6, dtype=np.int64).reshape(2, 3),
                  np.ones((2,), np.float32)]
        assert q.push(native.encode_batch(arrays), 9)
        seq, buf = q.pop(timeout_ms=1000)
        assert seq == 9
        back = native.decode_batch(buf)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(arrays, back))
        assert q.pop(timeout_ms=10) is None
        with pytest.raises(ValueError, match="exceeds slot size"):
            q.push(b"x" * (1 << 13), 1)
    finally:
        q.close()
    with pytest.raises(RuntimeError, match="open failed"):
        native.ShmQueue(f"/ptt_test_missing_{os.getpid()}", create=False)


def test_a_compile_error_raises_with_the_compilers_message(tmp_path,
                                                           monkeypatch):
    bad = tmp_path / "shm_queue.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
