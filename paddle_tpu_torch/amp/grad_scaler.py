"""GradScaler with dynamic loss scaling — the port of
``paddle_tpu/amp/grad_scaler.py``.

The eager API (``scale``, ``unscale_``, ``step``, ``update``, ``minimize``,
``state_dict`` with the reference's keys) is the reference's, host reads
included: ``unscale_`` reads whether a gradient is non-finite, as the
reference's ``bool(...)`` does.  Under ``jit.TrainStep(..., scaler=)`` the
scale, the skip and the dynamics run on the device with no host sync
(``TrainStep._scaled_step``), and the fields ``_scale``, ``_good_steps``
and ``_bad_steps`` become device tensors, as the reference's become device
arrays; ``get_loss_scaling`` and ``state_dict`` read them on the host only
when called.

An unscaled gradient is ``g * inv`` with ``inv = 1 / scale`` rounded to
the gradient's dtype first, as JAX rounds a weak-typed scalar.
"""
from __future__ import annotations

import torch

__all__ = ["GradScaler"]


def _host(x):
    """A Python number from a field that may be a device tensor."""
    return x.item() if isinstance(x, torch.Tensor) else x


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return float(_host(self._scale))

    def set_init_loss_scaling(self, v: float):
        self._scale = float(v)

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        # 1 / scale in the scale's own precision (a Python float's double,
        # a device field's float32), rounded once to each gradient's dtype
        inv = 1.0 / torch.as_tensor(self._scale, dtype=torch.float64
                                    if isinstance(self._scale, float)
                                    else torch.float32)
        nonfinite = None
        with torch.no_grad():
            for p in optimizer._parameter_list:
                if p.grad is not None:
                    g = p.grad.mul_(inv.to(device=p.grad.device,
                                           dtype=p.grad.dtype))
                    c = torch.logical_not(torch.isfinite(g)).sum()
                    nonfinite = c if nonfinite is None else nonfinite + c
        # one host read per step, not per parameter
        self._found_inf = (bool(nonfinite > 0) if nonfinite is not None
                           else False)
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not self._enable or not self._dynamic:
            return
        scale = float(_host(self._scale))
        good, bad = int(_host(self._good_steps)), int(_host(self._bad_steps))
        if self._found_inf:
            bad += 1
            good = 0
            if bad >= self._decr_every_n:
                scale = max(scale * self._decr_ratio, 1.0)
                bad = 0
        else:
            good += 1
            bad = 0
            if good >= self._incr_every_n_steps:
                scale *= self._incr_ratio
                good = 0
        self._scale, self._good_steps, self._bad_steps = scale, good, bad
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def state_dict(self):
        return {
            "scale": float(_host(self._scale)),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n,
            "incr_count": int(_host(self._good_steps)),
            "decr_count": int(_host(self._bad_steps)),
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)
