"""Hand-written Hopper (sm_90a) kernels, one module per kernel source in
``paddle_tpu_torch/csrc/``, mirroring ``paddle_tpu/ops/pallas/``.  Each
module keeps the kernel's plain PyTorch version beside its wrapper.

Importing this package registers the ``torch.library`` ops of the
kernels an exported program calls (``_build.kernel_op``:
``paddle_tpu_torch::rms_norm``, ``::rms_norm_residual``, ``::rope``,
``::swiglu``, ``::flash_attention``, ``::int8_linear``), so
``torch.export.load`` finds them (``jit/serialization.py`` imports it
first)."""
from __future__ import annotations

from typing import Callable, Dict

from . import flash_attention, fused_norm, fused_ops, int8_matmul  # noqa: F401

__all__ = ["launch_counters"]


def launch_counters() -> Dict[str, Callable]:
    """Every kernel wrapper that counts its launches, by kernel name: each
    adds one to its ``launches`` (B7 also to ``bias_launches`` when it
    fuses a bias) where it launches its kernel.  A CUDA graph's replay
    runs no wrapper and adds the counts its capture recorded
    (``jit/graphs.py``)."""
    from . import decode_attention as da
    from . import flash_attention as fa
    from . import fused_norm, fused_ops
    from . import paged_attention as pa
    from .fused_adamw import fused_adamw
    from .int8_matmul import int8_matmul

    return {"rms_norm": fused_norm.rms_norm_fused,
            "rms_norm_residual": fused_norm.rms_norm_residual_fused,
            "rope": fused_ops.rope_fused,
            "rope_ring": fused_ops.rope_ring_fused,
            "rope_bwd": fused_ops.rope_bwd_fused,
            "swiglu": fused_ops.swiglu_fused,
            "swiglu_bwd": fused_ops.swiglu_bwd_fused,
            "paged_attention": pa.paged_attention,
            "paged_attention_int8": pa.paged_attention_int8,
            "flash_attention": fa.flash_attention_fused,
            "decode_attention": da.decode_attention,
            "kv_ring_write": da.kv_ring_write,
            "flash_attention_bwd": fa.flash_attention_bwd_fused,
            "fused_adamw": fused_adamw,
            "int8_matmul": int8_matmul}
