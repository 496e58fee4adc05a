"""``TrainStep`` — the port of ``paddle_tpu/jit/api.py``'s ``TrainStep``
(``:411-699``) with the same call surface.

The reference compiles forward, gradients and the optimizer update into one
XLA program.  PyTorch runs eagerly: a step here is ``loss_fn(model,
*batch)`` inside the step's random context, ``loss.backward()``, the
optimizer's own ``_step`` under ``torch.no_grad`` (its ``grad_clip`` per
parameter group; AdamW: kernel B9), and the gradients cleared.  Nothing in
a step waits for the device: the loss comes back as a tensor on it.

- **Random stream.**  Each call takes one key from the default generator
  (``next_key``, made on the device from fills: no host sync) and runs the
  forward under a ``trace_state.TraceContext``: the i-th draw (a dropout
  mask) uses ``fold_in(key, i)``, the reference's key chain inside its
  trace.
- **Scaler** (``amp.GradScaler``, dynamic loss scaling): the loss times
  the scale, the gradients times ``1 / scale`` rounded to each gradient's
  dtype (``torch._foreach_mul_``), one non-finite check (each gradient's
  largest |g|, ``torch._foreach_norm``), the clip, the update and its
  skip (``optimizer.Skip``: B9 writes nothing and each step count stays
  where a gradient is not finite), and the scale's dynamics, all as
  device tensors (``_scaled_step``, ``api.py:483-575``).
  The scaler's ``_scale``, ``_good_steps`` and ``_bad_steps`` become those
  tensors; its ``get_loss_scaling`` / ``state_dict`` read them when asked.
- **Learning rate.**  Read on the host once a call (a scheduler's
  ``last_lr``); ``run_steps`` K steps over the leading dim of stacked
  batches with one rate for the window, the step keys ``fold_in(key, i)``
  of one window key, and returns the [K] losses stacked on the device.

Capturing the step in a CUDA graph, the counterpart of the compile, is
later work.
"""
from __future__ import annotations

import torch

from ..framework.random import default_generator, fold_in
from ..optimizer.optimizer import Skip
from . import trace_state

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, scaler=None):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.scaler = (scaler if scaler is not None and scaler.is_enable()
                       else None)
        self._params = list(model.parameters())
        self._device = (self._params[0].device if self._params
                        else torch.device("cpu"))
        # state complete before the first step, as the reference's
        optimizer._ensure_state()

    # ------------------------------------------------------------ scaler
    def _scaler_state(self):
        """The scaler's (scale float32, good int32, bad int32) as 0-d
        tensors on the model's device, made by fills (no host-to-device
        copy) from host values the first time and after
        ``set_init_loss_scaling``."""
        s, dev = self.scaler, self._device

        def on_device(x, dtype):
            if isinstance(x, torch.Tensor) and x.device == dev:
                return x
            return torch.full((), float(x) if dtype.is_floating_point
                              else int(x), dtype=dtype, device=dev)

        return (on_device(s._scale, torch.float32),
                on_device(s._good_steps, torch.int32),
                on_device(s._bad_steps, torch.int32))

    @torch.no_grad()
    def _unscale(self, scale) -> torch.Tensor:
        """Unscale every gradient in place, ``g * (1 / scale)`` with the
        inverse rounded to g's dtype (the reference's ``inv.astype(
        g.dtype)``); return the 0-d bool ``found_inf`` over the unscaled
        gradients."""
        grads = [p.grad for p in self._params if p.grad is not None]
        if not grads:
            return torch.zeros((), dtype=torch.bool, device=self._device)
        inv = 1.0 / scale
        by_dtype = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for dt, gs in by_dtype.items():
            torch._foreach_mul_(gs, inv.to(dt))
        # the largest |g| is finite exactly when every element is
        return torch.stack(torch._foreach_norm(
            grads, float("inf"))).isfinite().all().logical_not()

    @torch.no_grad()
    def _dynamics(self, scale, good, bad, found_inf):
        """The reference's dynamic loss scaling on the device."""
        s = self.scaler
        bad = torch.where(found_inf, bad + 1, 0)
        good = torch.where(found_inf, 0, good + 1)
        dec = bad >= s._decr_every_n
        scale = torch.where(dec, torch.clamp(scale * s._decr_ratio, min=1.0),
                            scale)
        bad = torch.where(dec, 0, bad)
        inc = good >= s._incr_every_n_steps
        scale = torch.where(inc, scale * s._incr_ratio, scale)
        good = torch.where(inc, 0, good)
        return scale, good, bad

    def _scaled_step(self, loss, lr: float):
        scale, good, bad = self._scaler_state()
        (loss * scale.to(loss.dtype)).backward()
        found_inf = self._unscale(scale)
        self.optimizer._step(lr, Skip.of(found_inf))
        if self.scaler._dynamic:
            scale, good, bad = self._dynamics(scale, good, bad, found_inf)
        s = self.scaler
        s._scale, s._good_steps, s._bad_steps = scale, good, bad

    # -------------------------------------------------------------- step
    def _one(self, batch, lr: float, key) -> torch.Tensor:
        with trace_state.activate(trace_state.TraceContext(key)):
            loss = self.loss_fn(self.model, *batch)
        if self.scaler is None:
            loss.backward()
            self.optimizer._step(lr)
        else:
            self._scaled_step(loss, lr)
        self.optimizer.clear_grad()
        return loss.detach()

    def __call__(self, *batch) -> torch.Tensor:
        """One training step -> the loss (a 0-d tensor on the device)."""
        key = default_generator().next_key(self._device)
        return self._one(batch, self.optimizer.get_lr(), key)

    step = __call__

    def sync_to_model(self):
        """The model: its parameters are updated in place by every step,
        so there is nothing to write back (the reference copies its
        compiled state into the model here)."""
        return self.model

    def run_steps(self, *batch_stacks) -> torch.Tensor:
        """K steps, step i on ``[x[i] for x in batch_stacks]`` (each a
        tensor with leading dim K) with the key ``fold_in(window key, i)``,
        at the learning rate read once for the window -> the [K] losses."""
        if not batch_stacks:
            raise ValueError("run_steps needs at least one tensor input")
        K = int(batch_stacks[0].shape[0])
        lr = self.optimizer.get_lr()
        window = default_generator().next_key(self._device)
        losses = [self._one([x[i] for x in batch_stacks], lr,
                            fold_in(window, i)) for i in range(K)]
        return torch.stack(losses)
