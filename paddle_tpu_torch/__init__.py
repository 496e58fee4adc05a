"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

The JAX package stays beside this one as the reference each ported part is
held against.  This package imports ``torch`` and never ``jax`` or
``paddle_tpu``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see ``device.py``); every hand-written Hopper kernel lives
under ``ops/hopper/`` with its plain PyTorch version beside it.
``save`` / ``load`` (``framework_io``) and ``Model`` / ``summary``
(``hapi``) are exported here, as the reference exports them.
"""
from __future__ import annotations

import torch as _torch

__version__ = "0.1.0"

# Float32 means float32, as paddle_tpu/__init__.py pins matmul precision to
# "highest": no TF32 in float32 matrix products or convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .device import resolve_device  # noqa: E402,F401
from .framework_io import load, save  # noqa: E402,F401
from .hapi import Model, summary  # noqa: E402,F401
