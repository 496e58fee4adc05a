"""``TrainStep`` — the port of ``paddle_tpu/jit/api.py``'s ``TrainStep``
(``:411-699``) with the same call surface.

The reference compiles forward, gradients and the optimizer update into one
XLA program.  PyTorch runs eagerly: a step here is ``loss_fn(model,
*batch)``, ``loss.backward()``, the optimizer's own ``step`` under
``torch.no_grad`` (AdamW: kernel B9), and the gradients cleared.  Nothing
in a step waits for the device: the loss comes back as a tensor on it.
``run_steps`` runs K steps over the leading dim of stacked batches with one
learning rate for the window and returns the [K] losses stacked on the
device.  A ``scaler`` (AMP) is not ported yet, and capturing the step in a
CUDA graph, the counterpart of the compile, is later work.
"""
from __future__ import annotations

import torch

__all__ = ["TrainStep"]


class TrainStep:
    def __init__(self, model, loss_fn, optimizer, scaler=None):
        if scaler is not None:
            raise NotImplementedError(
                "TrainStep: a GradScaler (AMP) is not ported yet")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        # state complete before the first step, as the reference's
        optimizer._ensure_state()

    def _one(self, batch, lr: float) -> torch.Tensor:
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.optimizer._step(lr)
        self.optimizer.clear_grad()
        return loss.detach()

    def __call__(self, *batch) -> torch.Tensor:
        """One training step -> the loss (a 0-d tensor on the device)."""
        return self._one(batch, self.optimizer.get_lr())

    step = __call__

    def run_steps(self, *batch_stacks) -> torch.Tensor:
        """K steps, step i on ``[x[i] for x in batch_stacks]`` (each a
        tensor with leading dim K), at the learning rate read once for the
        window -> the [K] losses."""
        if not batch_stacks:
            raise ValueError("run_steps needs at least one tensor input")
        K = int(batch_stacks[0].shape[0])
        lr = self.optimizer.get_lr()
        losses = [self._one([x[i] for x in batch_stacks], lr)
                  for i in range(K)]
        return torch.stack(losses)
