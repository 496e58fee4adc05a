"""Device choice for the port's entry points.

``device=None`` means the card.  Without CUDA that is an error, never a
quiet move to the CPU: a caller who wants the plain CPU path (the tests)
asks for it with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` when CUDA is missing);
    an explicit device is returned as a ``torch.device``, checked the same
    way when it names CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
