"""Optimizers of the port (``paddle_tpu/optimizer/``): the ``Optimizer``
base (``grad_clip`` per parameter group), ``Adam``, ``AdamW`` (fused
update: kernel B9) and the learning-rate schedulers of ``lr``."""
from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW", "lr"]
