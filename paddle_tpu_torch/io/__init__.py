"""Data loading — the port of ``paddle_tpu/io``: the datasets, the seven
samplers, ``DataLoader`` (forked workers over the shared-memory ring of
``paddle_tpu_torch/native``) and ``get_worker_info``."""
from .dataset import (  # noqa: F401
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .reader import DataLoader, default_collate_fn  # noqa: F401
from .sampler import (  # noqa: F401
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
)


class WorkerInfo:
    """A worker's id, the number of workers, its seed and the dataset."""

    def __init__(self, id, num_workers, dataset=None):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.seed = id
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """Inside a DataLoader worker process its ``WorkerInfo``; None in the
    main process."""
    return _worker_info
