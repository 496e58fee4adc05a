"""Optimizers of the port (``paddle_tpu/optimizer/``): the ``Optimizer``
base (``grad_clip`` per parameter group), the reference's 15 optimizers
(``AdamW``'s fused update: kernel B9) and the learning-rate schedulers of
``lr``."""
from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (  # noqa: F401
    ASGD,
    LBFGS,
    SGD,
    Adadelta,
    Adagrad,
    Adam,
    Adamax,
    AdamW,
    Lamb,
    Lars,
    Momentum,
    NAdam,
    RAdam,
    RMSProp,
    Rprop,
)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "LBFGS", "ASGD",
           "Rprop", "NAdam", "RAdam", "lr"]
