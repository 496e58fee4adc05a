"""Fused AdamW update — Hopper kernel B9 (``csrc/fused_adamw.cu``).

Port of ``paddle_tpu/ops/pallas/fused_adamw.py``: ``fused_adamw`` replaces
the Pallas ``fused_adamw`` (its ``_kernel``).  One pass reads the gradient,
the float32 master weight and the two moments, and writes the master
weight and moments IN PLACE and the parameter in its own dtype (the
reference returns new arrays and aliases them through the call).  The step
count ``t`` (the parameter's ``beta_pow`` accumulator, already advanced) is
a one-element float32 tensor on the device, read by the kernel: an update
needs no host sync.  Two optional one-element float32 device tensors steer
a step of ``TrainStep`` without a host read: ``gmul``, a clip's scale (the
gradient is read as ``float(round_to_grad_dtype(float(g) * gmul))``, the
reference's ``(g * scale).astype(g.dtype)`` widened under
``multi_precision``), and ``skip``, nonzero where a scaler found a
non-finite gradient (nothing is written: parameter, master and moments
keep their bits).  Bound on the H100 by bytes (see the source's note).

``fused_adamw`` runs the plain version (``_fused_adamw_ref``, the Pallas
kernel's arithmetic transcribed) only for CPU tensors.  For CUDA tensors it
launches the kernel or raises; ``launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["fused_adamw"]


def _fused_adamw_ref(param, master, m, v, grad, lr, t, b1, b2, eps, wd,
                     gmul=None, skip=None):
    gf = (grad.float() if gmul is None
          else (grad.float() * gmul).to(grad.dtype).float())
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    nw = master * (1.0 - lr * wd)
    nm = m * b1 + (1.0 - b1) * gf
    nv = v * b2 + (1.0 - b2) * gf * gf
    nw = nw - lr * ((nm / c1) / (torch.sqrt(nv / c2) + eps))
    own = param.data_ptr() == master.data_ptr()
    if skip is not None:
        keep = skip.reshape(()) != 0
        nw, nm, nv = (torch.where(keep, old, new) for old, new in
                      ((master, nw), (m, nm), (v, nv)))
        if not own:
            param.copy_(torch.where(keep, param, nw.to(param.dtype)))
    master.copy_(nw)
    m.copy_(nm)
    v.copy_(nv)
    if not own and skip is None:
        param.copy_(master)


def _check(name, param, master, m, v, grad, t, gmul=None, skip=None):
    n = param.numel()
    for what, x in (("master", master), ("m", m), ("v", v)):
        if x.dtype != torch.float32 or x.numel() != n:
            raise ValueError(f"{name}: {what} must be float32 with "
                             f"{n} elements, got {x.dtype} {x.numel()}")
    if grad.numel() != n:
        raise ValueError(f"{name}: grad has {grad.numel()} elements, the "
                         f"parameter {n}")
    for what, x in (("the step count t", t), ("gmul", gmul),
                    ("skip", skip)):
        if x is not None and (x.dtype != torch.float32 or x.numel() != 1):
            raise ValueError(f"{name}: {what} must be one float32")
    for x in (param, master, m, v, grad, t, gmul, skip):
        if x is None:
            continue
        if x.device != param.device:
            raise ValueError(f"{name}: all operands must be on "
                             f"{param.device}, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def fused_adamw(param: torch.Tensor, master: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, grad: torch.Tensor, lr: float,
                t: torch.Tensor, *, b1: float, b2: float, eps: float,
                wd: float, gmul: Optional[torch.Tensor] = None,
                skip: Optional[torch.Tensor] = None):
    """One AdamW step with decoupled decay, in place: ``master``, ``m``,
    ``v`` float32 and ``param`` (bfloat16 or float32; pass the master
    itself for a float32 parameter that has none) take the new values.
    ``grad`` is float32 or bfloat16, converted exactly in registers (times
    ``gmul`` and rounded to its dtype first, where given); ``t`` the step
    count after this step's increment; nothing is written where ``skip``
    is nonzero.  Returns (param, master, m, v)."""
    if param.device.type == "cpu":
        _fused_adamw_ref(param, master, m, v, grad, float(lr), t, b1, b2,
                         eps, wd, gmul, skip)
        return param, master, m, v
    name = "fused_adamw"
    _check(name, param, master, m, v, grad, t, gmul, skip)
    own = param.data_ptr() == master.data_ptr()
    p_dt = _build.dtype_code(name, param)
    g_dt = _build.dtype_code(name, grad)
    stream = torch.cuda.current_stream(param.device).cuda_stream
    if param.numel():
        with _build.device_guard(param):
            _build.check(_build.lib().ptt_fused_adamw(
                None if own else param.data_ptr(), master.data_ptr(),
                m.data_ptr(), v.data_ptr(), grad.data_ptr(), t.data_ptr(),
                None if gmul is None else gmul.data_ptr(),
                None if skip is None else skip.data_ptr(), param.numel(),
                float(lr), float(b1), float(b2), float(1.0 - b1),
                float(1.0 - b2), float(eps), float(wd), p_dt, g_dt, stream),
                name)
        fused_adamw.launches += 1
    return param, master, m, v


fused_adamw.launches = 0
