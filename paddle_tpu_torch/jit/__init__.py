"""The port's counterpart of ``paddle_tpu/jit/``: ``TrainStep``, and the
CUDA graph cache over device loops (``graphs.py``) that takes the place of
the reference's compiled programs."""
from .api import TrainStep  # noqa: F401

__all__ = ["TrainStep"]
