"""The training step of the port (``paddle_tpu/jit/``): ``TrainStep``."""
from .api import TrainStep  # noqa: F401

__all__ = ["TrainStep"]
