"""The callbacks namespace (``paddle_tpu/callbacks.py``): a re-export of
``hapi.callbacks``."""
from .hapi.callbacks import (  # noqa: F401
    Callback,
    EarlyStopping,
    LRScheduler,
    ModelCheckpoint,
    ProgBarLogger,
    ReduceLROnPlateau,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "ReduceLROnPlateau"]
