"""paddle_tpu_torch.amp — the port of ``paddle_tpu/amp`` (``auto_cast``,
``decorate``, ``GradScaler``, the op lists).  ``amp/debugging.py`` is not
ported."""
from . import amp_lists  # noqa: F401
from .auto_cast import (  # noqa: F401
    amp_cast,
    amp_guard,
    amp_state,
    auto_cast,
    decorate,
    get_amp_dtype,
    is_auto_cast_enabled,
)
from .grad_scaler import GradScaler  # noqa: F401

__all__ = ["amp_lists", "auto_cast", "amp_guard", "amp_state", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype", "amp_cast", "GradScaler",
           "is_bfloat16_supported", "is_float16_supported"]


def is_bfloat16_supported(device=None) -> bool:
    """The H100 computes bfloat16 in its tensor cores, and the CPU's plain
    versions compute it too."""
    return True


def is_float16_supported(device=None) -> bool:
    """float16 casts and runs through the plain versions on the CPU; on
    CUDA the port's kernels refuse it (ROADMAP F16)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cpu"
