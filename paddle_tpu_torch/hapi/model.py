"""The high-level ``Model`` — the port of ``paddle_tpu/hapi/model.py``
(``Model.prepare/fit/evaluate/predict/save/load/summary`` and ``summary``).

A ``Model`` runs where its network's parameters are, as the port's
``Predictor`` does: each batch (CPU tensors from ``io.DataLoader``, or
numpy) is moved there, from pinned memory with ``non_blocking`` on CUDA.
``train_batch`` builds the port's ``TrainStep`` over the network, the loss
and the optimizer, as the reference does, and reads the loss to the host
every step, the path's one sync a step; the step itself waits for nothing.
``fit(accumulate_grad_batches=n > 1)`` runs the eager backward of each
micro-batch and ``optimizer.step()`` / ``clear_grad()`` every ``n``.
``evaluate`` and ``predict`` run the network in eval mode under
``torch.no_grad``.  ``save`` / ``load`` write and read ``.pdparams`` and
``.pdopt`` through the port's ``framework_io``, in the reference's layout.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from .. import framework_io
from ..io import DataLoader
from ..metric import Metric

__all__ = ["Model", "summary"]


def _to(device: torch.device, x):
    """``x`` (a tensor, an array, or a list / tuple of them) on
    ``device``."""
    if isinstance(x, (list, tuple)):
        return type(x)(_to(device, v) for v in x)
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if not isinstance(x, torch.Tensor) or x.device == device:
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _listed(x) -> list:
    return list(x if isinstance(x, (list, tuple)) else [x])


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self.stop_training = False

    @property
    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        return p.device if p is not None else torch.device("cpu")

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = (metrics if isinstance(metrics, (list, tuple))
                             else [metrics])
        return self

    # ------------------------------------------------------------ training
    def _loss_fn(self, net, *batch):
        *xs, y = batch
        return self._loss(net(*xs), y)

    def train_batch(self, inputs, labels=None):
        """One ``TrainStep`` on the batch -> ``[loss]`` as a float."""
        from ..jit import TrainStep

        if self._train_step is None:
            self._train_step = TrainStep(self.network, self._loss_fn,
                                         self._optimizer)
        batch = _listed(inputs)
        if labels is not None:
            batch += _listed(labels)
        loss = self._train_step(*_to(self._device, batch))
        return [float(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """-> (the loss as a float or None, the outputs) in eval mode."""
        was_training = self.network.training
        self.network.eval()
        out = self.network(*_to(self._device, _listed(inputs)))
        loss = None
        if self._loss is not None and labels is not None:
            y = labels[0] if isinstance(labels, (list, tuple)) else labels
            loss = float(self._loss(out, _to(self._device, y)))
        if was_training:
            self.network.train()
        return loss, out

    @torch.no_grad()
    def predict_batch(self, inputs):
        was_training = self.network.training
        self.network.eval()
        out = self.network(*_to(self._device, _listed(inputs)))
        if was_training:
            self.network.train()
        return out

    def _accumulated_batch(self, xs, y, bi, accum):
        """Gradient accumulation on the eager path: backward each
        micro-batch, step every ``accum`` batches."""
        dev = self._device
        loss_t = self._loss(self.network(*_to(dev, _listed(xs))),
                            _to(dev, y)) / accum
        loss_t.backward()
        loss = float(loss_t.detach()) * accum
        if (bi + 1) % accum == 0:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return loss

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from .callbacks import config_callbacks

        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last, num_workers=num_workers)
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs,
            steps=len(loader) if hasattr(loader, "__len__") else None,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir,
            metrics=[m.name() for m in self._metrics
                     if callable(getattr(m, "name", None))])
        self.stop_training = False
        history = {"loss": []}
        it = 0
        accum = max(int(accumulate_grad_batches), 1)
        cbks.on_train_begin()
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            epoch_losses = []
            for bi, batch in enumerate(loader):
                cbks.on_train_batch_begin(bi)
                xs, y = batch[:-1], batch[-1]
                if accum > 1:
                    loss = self._accumulated_batch(xs, y, bi, accum)
                else:
                    loss = self.train_batch(xs, y)[0]
                epoch_losses.append(loss)
                it += 1
                cbks.on_train_batch_end(bi, {"loss": loss})
                if num_iters is not None and it >= num_iters:
                    break
            epoch_loss = (float(np.mean(epoch_losses)) if epoch_losses
                          else None)
            history["loss"].append(epoch_loss)
            logs = {"loss": epoch_loss}
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                res = self.evaluate(eval_data, batch_size=batch_size,
                                    verbose=verbose)
                for k, v in res.items():
                    if isinstance(v, list):
                        v = v[0] if v else None
                    # the eval loss as val_loss, the metrics by their names:
                    # what EarlyStopping / ReduceLROnPlateau monitor
                    logs["val_loss" if k == "loss" else k] = v
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
            if num_iters is not None and it >= num_iters:
                break
        cbks.on_train_end({"loss": history["loss"][-1] if history["loss"]
                           else None})
        if self._train_step is not None:
            self._train_step.sync_to_model()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
        if self._train_step is not None:
            self._train_step.sync_to_model()
        for m in self._metrics:
            m.reset()
        losses = []
        for i, batch in enumerate(loader):
            xs, y = batch[:-1], _to(self._device, batch[-1])
            loss, out = self.eval_batch(xs, y)
            if loss is not None:
                losses.append(loss)
            for m in self._metrics:
                computed = m.compute(out, y)
                if isinstance(computed, (list, tuple)):
                    m.update(*computed)
                else:
                    m.update(computed)
            if num_iters is not None and i + 1 >= num_iters:
                break
        result = {"loss": [float(np.mean(losses))] if losses else []}
        for m in self._metrics:
            result[m.name()] = m.accumulate()
        if verbose:
            print("Eval:", result)
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """The network's outputs batch by batch (tensors on its device)."""
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        outputs = []
        for batch in loader:
            if isinstance(batch, (list, tuple)):
                xs = batch[:-1] if len(batch) > 1 else [batch[0]]
            else:
                xs = [batch]
            outputs.append(self.predict_batch(xs))
        return outputs

    # ------------------------------------------------------------ persistence
    def save(self, path, training=True):
        if self._train_step is not None:
            self._train_step.sync_to_model()
        framework_io.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            framework_io.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """The network's weights from ``path + ".pdparams"``, and the
        optimizer's state from ``path + ".pdopt"`` where that file exists
        (the reference goes on without it)."""
        self.network.load_state_dict(framework_io.load(path + ".pdparams"),
                                     strict=not skip_mismatch)
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._optimizer.set_state_dict(framework_io.load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net, input_size=None, dtypes=None):
    """The parameter count table of ``net``; returns the total and
    trainable counts."""
    rows = []
    total = trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = ["-" * (width + 30),
             f"{'Layer (param)':<{width}}{'Shape':<18}{'Params':>10}",
             "-" * (width + 30)]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<18}{n:>10}")
    lines += ["-" * (width + 30), f"Total params: {total}",
              f"Trainable params: {trainable}"]
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
