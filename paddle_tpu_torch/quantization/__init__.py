"""Weight-only quantization — the port of the weight-only tier of
``paddle_tpu/quantization/__init__.py`` (``weight_quantize``,
``weight_dequantize``, ``weight_only_linear``).

int8 weights run through kernel B7 (``ops/hopper/int8_matmul.py``, the
bias in its epilogue); fp8 (e4m3fn) weights are widened to the
activation's dtype before one ``torch.matmul``, as the reference does in
jnp with no kernel.  QAT, PTQ and the observers are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.hopper.int8_matmul import int8_linear

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]

_FP8_MAX = 448.0  # e4m3fn finite max
_FP8_ALGOS = ("weight_only_fp8", "fp8", "float8_e4m3fn")
_INT8_ALGOS = ("weight_only_int8", "int8")


def weight_quantize(w: torch.Tensor, algo: str = "weight_only_int8",
                    group_size: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [in, out] -> (quantized weight [in, out], per-column float32
    scales [out]) on w's device.

    ``weight_only_int8``/``int8``: ``scale = max(|w|.max(0), 1e-9) / 127``
    and ``q = clip(round(w / scale), -128, 127)`` (round half to even).
    ``weight_only_fp8``/``fp8``/``float8_e4m3fn``: scaled to +-448 and
    stored as ``torch.float8_e4m3fn``.  The arithmetic is float32 whatever
    w's dtype, as the reference's numpy promotes a bfloat16 weight, so the
    int8 values and scales are the reference's bit for bit.  Another
    ``algo`` raises ``ValueError``."""
    if algo not in _FP8_ALGOS + _INT8_ALGOS:
        raise ValueError(
            f"weight_quantize: unrecognized algo {algo!r}; supported: "
            "'weight_only_int8'/'int8', "
            "'weight_only_fp8'/'fp8'/'float8_e4m3fn'")
    wf = w.detach().float()
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, which is not numpy's correctly rounded quotient
    top = torch.tensor(127.0 if algo in _INT8_ALGOS else _FP8_MAX,
                       device=wf.device)
    scale = torch.clamp(wf.abs().amax(dim=0), min=1e-9) / top
    if algo in _FP8_ALGOS:
        q = torch.clamp(wf / scale, -_FP8_MAX, _FP8_MAX).to(
            torch.float8_e4m3fn)
    else:
        q = torch.clamp(torch.round(wf / scale), -128, 127).to(torch.int8)
    return q, scale


def weight_dequantize(qw: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8") -> torch.Tensor:
    """``float32(qw) * scale``."""
    return qw.float() * scale


def weight_only_linear(x: torch.Tensor, qweight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       weight_scale: Optional[torch.Tensor] = None,
                       weight_dtype: str = "int8") -> torch.Tensor:
    """``x @ dequant(qweight) (+ bias)``.  int8 runs kernel B7 with the
    bias in its epilogue (``int8_linear``: one launch, rounded as a
    separate add in the output's dtype); fp8 widens ``qweight *
    weight_scale`` to x's dtype first, runs ``torch.matmul`` and adds the
    bias afterwards, in the output's dtype."""
    if weight_dtype not in _FP8_ALGOS:
        return int8_linear(x, qweight, weight_scale, bias)
    w = qweight.to(x.dtype) * weight_scale.to(x.dtype)
    out = x @ w
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
