"""hapi callbacks — a copy of ``paddle_tpu/hapi/callbacks.py``
(``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``EarlyStopping``, ``LRScheduler``, ``ReduceLROnPlateau``,
``config_callbacks``).  They run on the host over the numbers ``Model.fit``
logs; ``LRScheduler`` steps the optimizer's scheduler of the port's
``optimizer.lr``."""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "ReduceLROnPlateau", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    # train
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    # eval
    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def fan_out(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return fan_out
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Step and epoch lines on the console."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and self.log_freq and (step + 1) % self.log_freq == 0:
            loss = (logs or {}).get("loss")
            msg = f"step {step + 1}"
            if loss is not None:
                msg += f": loss {float(loss):.4f}"
            print(msg)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            loss = (logs or {}).get("loss")
            extra = f" loss {float(loss):.4f}" if loss is not None else ""
            print(f"Epoch {epoch + 1}:{extra} ({time.time() - self._t0:.1f}s)")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and self.model is not None and (epoch + 1) % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")

    def on_train_end(self, logs=None):
        if self.save_dir and self.model is not None:
            self.model.save(f"{self.save_dir}/final")


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", mode: str = "auto", patience: int = 0,
                 verbose: int = 1, min_delta: float = 0.0, baseline=None,
                 save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _better(self, cur, best):
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = self.baseline

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                if self.model is not None:
                    self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor: str = "loss", factor: float = 0.1, patience: int = 10,
                 verbose: int = 1, mode: str = "auto", min_delta: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        better = (self.best is None or
                  (cur < self.best - self.min_delta if self.mode == "min"
                   else cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    lr = opt.get_lr() if hasattr(opt, "get_lr") else float(opt._learning_rate)
                    new_lr = max(lr * self.factor, self.min_lr)
                    if hasattr(opt, "set_lr"):
                        opt.set_lr(new_lr)
                    else:
                        opt._learning_rate = new_lr
                self.cooldown_counter = self.cooldown
                self.wait = 0


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                   "metrics": metrics or []})
    return cl
