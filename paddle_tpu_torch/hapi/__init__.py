"""The high-level API (``paddle_tpu/hapi``): ``Model`` with its callbacks,
and ``summary``."""
from . import callbacks  # noqa: F401
from .model import Model, summary  # noqa: F401
