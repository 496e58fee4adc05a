"""Adam and AdamW — the port of ``paddle_tpu/optimizer/optimizers.py``
(``Adam`` ``:47-75``, ``AdamW`` ``:78-151``).

``_update_param`` is the plain version, the reference's arithmetic in torch
ops.  On CUDA, AdamW updates every parameter whose state is float32 (a
float32 parameter, or a low-precision one with its master weight under
``multi_precision``) in one launch of kernel B9
(``ops/hopper/fused_adamw.py``), the counterpart of the reference's
``_try_fused_update``; its ``n % (512 * 256)`` rule and its opt-in switch
are TPU matters and do not carry over.  A bfloat16 parameter without
master weights keeps bfloat16 moments, as in the reference, and takes the
plain update; so does every parameter on the CPU.
"""
from __future__ import annotations

import torch

from ..ops.hopper.fused_adamw import fused_adamw
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _beta_pow(self, p) -> torch.Tensor:
        return self._acc("beta_pow", p, init=torch.zeros(
            (), dtype=torch.float32, device=p.device))

    def _create_accumulators(self, p):
        self._acc("moment1", p)
        self._acc("moment2", p)
        self._beta_pow(p)

    def _moments(self, p, grad, t):
        m = self._beta1 * self._acc("moment1", p) + (1 - self._beta1) * grad
        v = (self._beta2 * self._acc("moment2", p)
             + (1 - self._beta2) * grad * grad)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        return m / (1 - self._beta1 ** t), v / (1 - self._beta2 ** t)

    def _decay(self, w, grad, lr, weight_decay):
        """-> (w, grad): Adam's decay is L2 regularization on the grads."""
        return w, (grad + weight_decay * w if weight_decay else grad)

    def _update_param(self, p, grad, lr, weight_decay):
        w, grad = self._decay(self._master(p), grad, lr, weight_decay)
        t = self._beta_pow(p) + 1
        self._set_acc("beta_pow", p, t)
        mhat, vhat = self._moments(p, grad, t)
        self._write_back(p, w - (lr * mhat / (torch.sqrt(vhat)
                                              + self._epsilon)).to(w.dtype))


class AdamW(Adam):
    """Decoupled weight decay (the reference's ``adamw.py``): the decay is
    AdamW's own ``weight_decay``, not a group's."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, multi_precision)
        self._wd = float(weight_decay)

    def _apply_update(self, p, grad, lr, wd, gmul=None, skip=None):
        if not (p.is_cuda and self._master(p).dtype == torch.float32):
            return super()._apply_update(p, grad, lr, wd, gmul, skip)
        # B9: one pass over the raw gradient (scaled by the clip's gmul and
        # rounded, then widened, in registers), master/moments in place;
        # under a set skip flag the kernel writes nothing and t stays
        self._create_accumulators(p)
        t = self._beta_pow(p)
        t.add_(1 if skip is None else skip.advance)
        fused_adamw(p.data, self._master(p), self._acc("moment1", p),
                    self._acc("moment2", p), grad.contiguous(), lr, t,
                    b1=self._beta1, b2=self._beta2, eps=self._epsilon,
                    wd=self._wd, gmul=gmul,
                    skip=None if skip is None else skip.flag)

    def _decay(self, w, grad, lr, weight_decay):
        return (w * (1 - lr * self._wd) if self._wd else w), grad
