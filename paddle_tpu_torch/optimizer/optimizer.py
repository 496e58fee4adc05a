"""Optimizer base — the port of ``paddle_tpu/optimizer/optimizer.py``
(``Optimizer``, ``:25-191``).

The reference's parts: parameter groups with a group ``learning_rate``
(a factor on the base rate) and ``weight_decay``; accumulators per
parameter; float32 master weights for low-precision parameters under
``multi_precision`` (``_master``, ``_write_back``); ``step``, which
casts the gradients to float32 under ``multi_precision``; ``clear_grad``;
``state_dict`` / ``set_state_dict`` with the reference's keys
(``<param>__<accumulator>``, ``<param>__master_weight``, ``@step``, and
``LR_Scheduler``), each saved state keeping its dtype on load (a
bfloat16 moment stays bfloat16, as ``paddle_tpu/optimizer/optimizer.py:
187-191`` keeps it); a ``grad_clip`` (``nn/clip.py``) applied to each
parameter group's gradients before its update, as in
``paddle_tpu/optimizer/optimizer.py:106-107``.  A parameter is named by its
position, ``param_<i>``, the reference's name for a parameter without one.

State lives on each parameter's device as torch tensors; the update runs
under ``torch.no_grad`` and writes the parameters through ``.data``, so no
version counter of a graph moves.  A clip reaches the update as a float32
device scale per gradient (``gmul``: the gradient is read as ``(g * gmul)``
rounded to its dtype), and ``TrainStep``'s scaler as a skip flag
(``Skip``): where it is set, every state of the parameter keeps its bits,
the reference's ``jnp.where(found_inf, old, new)`` (``jit/api.py:556-562``).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.float16, torch.bfloat16)


class Skip(NamedTuple):
    """A step's skip on the device: ``flag`` float32 [] is 1 where the
    update is skipped (a non-finite gradient under a scaler), else 0;
    ``advance`` is ``1 - flag``, what each step count moves by."""
    flag: torch.Tensor
    advance: torch.Tensor

    @classmethod
    def of(cls, found_inf: torch.Tensor) -> "Skip":
        flag = found_inf.to(torch.float32)
        return cls(flag, 1.0 - flag)


def _state_tensor(val) -> torch.Tensor:
    """A saved state as a tensor of its own dtype.  A bfloat16 numpy array
    (``ml_dtypes``, what the reference's ``framework_io`` writes for a
    bfloat16 leaf) is read through float32, exactly, so ``ml_dtypes`` is
    not imported."""
    if isinstance(val, torch.Tensor):
        return val
    arr = np.asarray(val)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        params = list(parameters)
        if params and isinstance(params[0], dict):
            self._param_groups = params
            self._parameter_list = [p for g in params for p in g["params"]]
        else:
            self._param_groups = [{"params": params}]
            self._parameter_list = params
        self._learning_rate = learning_rate
        self._weight_decay = self._parse_decay(weight_decay)
        self._multi_precision = multi_precision
        self._grad_clip = grad_clip
        # accumulators: name -> {id(param): tensor}
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = \
            defaultdict(dict)
        self._master_weights: Dict[int, torch.Tensor] = {}
        self._step_count = 0

    @staticmethod
    def _parse_decay(weight_decay) -> float:
        return 0.0 if weight_decay is None else float(weight_decay)

    # ----------------------------------------------------------- lr
    def get_lr(self) -> float:
        lr = self._learning_rate
        return lr() if isinstance(lr, LRScheduler) else float(lr)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # ----------------------------------------------------------- state
    def _acc(self, name: str, p: torch.Tensor, init=None) -> torch.Tensor:
        """The accumulator ``name`` of ``p``, made on first use: zeros like
        its master, or what ``init()`` returns."""
        d = self._accumulators[name]
        if id(p) not in d:
            d[id(p)] = (torch.zeros_like(self._master(p))
                        if init is None else init())
        return d[id(p)]

    def _beta_pow(self, p: torch.Tensor) -> torch.Tensor:
        """The float32 0-d step count ``beta_pow`` of the Adam family, on
        ``p``'s device."""
        return self._acc("beta_pow", p, init=lambda: torch.zeros(
            (), dtype=torch.float32, device=p.device))

    def _set_acc(self, name: str, p: torch.Tensor, value: torch.Tensor):
        self._accumulators[name][id(p)] = value

    def _master(self, p: torch.Tensor) -> torch.Tensor:
        """The float32 master weight of a low-precision ``p`` under
        ``multi_precision``; else ``p``'s own data."""
        if self._multi_precision and p.dtype in _LOW_PRECISION:
            if id(p) not in self._master_weights:
                self._master_weights[id(p)] = p.detach().float()
            return self._master_weights[id(p)]
        return p.data

    def _write_back(self, p: torch.Tensor, new_master: torch.Tensor):
        if id(p) in self._master_weights:
            self._master_weights[id(p)] = new_master
        p.data.copy_(new_master)

    # ----------------------------------------------------------- step
    def step(self):
        self._step(self.get_lr())

    @torch.no_grad()
    def _step(self, base_lr: float, skip: Optional[Skip] = None):
        """One update of every parameter that has a gradient, at
        ``base_lr`` times each group's ``learning_rate``, each group's
        gradients clipped by ``grad_clip``; none at all where ``skip``'s
        flag is set."""
        for group in self._param_groups:
            pg = [(p, p.grad) for p in group["params"]
                  if p.grad is not None and p.requires_grad]
            factors = (self._grad_clip._factors(pg)
                       if self._grad_clip is not None
                       else [(p, g, None) for p, g in pg])
            lr = base_lr * group.get("learning_rate", 1.0)
            wd = self._parse_decay(group.get("weight_decay",
                                             self._weight_decay))
            for p, g, gmul in factors:
                if g is not None:
                    self._apply_update(p, g, lr, wd, gmul, skip)
        self._step_count += 1

    def _apply_update(self, p, grad, lr: float, wd: float, gmul=None,
                      skip: Optional[Skip] = None):
        """The plain update: the clip's scale applied to the gradient in
        float32 and rounded to its dtype, the gradient widened to float32
        under ``multi_precision``, then ``_update_param``; under ``skip``
        every state of ``p`` is put back where the flag is set."""
        if gmul is not None:
            grad = (grad.float() * gmul).to(grad.dtype)
        g = grad.float() if self._multi_precision else grad
        if skip is None:
            self._update_param(p, g, lr, wd)
            return
        accs = {name: d[id(p)] for name, d in self._accumulators.items()
                if id(p) in d}
        master = self._master_weights.get(id(p))
        data = p.data.clone()
        self._update_param(p, g, lr, wd)
        keep = skip.flag > 0
        for name, old in accs.items():
            d = self._accumulators[name]
            d[id(p)] = torch.where(keep, old, d[id(p)])
        if master is not None:
            self._master_weights[id(p)] = torch.where(
                keep, master, self._master_weights[id(p)])
        p.data.copy_(torch.where(keep, data, p.data))

    def _update_param(self, p, grad, lr: float, weight_decay: float):
        raise NotImplementedError

    def _create_accumulators(self, p):
        """Create this optimizer's accumulators for ``p`` up front."""

    def _ensure_state(self):
        """Master weights and accumulators for every parameter, so the
        state is complete before the first step (``TrainStep``)."""
        for group in self._param_groups:
            for p in group["params"]:
                self._master(p)
                self._create_accumulators(p)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """A program's loss (a ``static`` variable): mark the current
        program for ``Executor.run`` to train (``_loss``,
        ``_optimizer``).  An eager loss: ``loss.backward()`` and
        ``step()``.  Returns (None, None), as the reference's."""
        from .. import static

        if static.is_variable(loss):
            prog = static.default_main_program()
            prog._loss = loss
            prog._optimizer = self
            return None, None
        loss.backward()
        self.step()
        return None, None

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    # ----------------------------------------------------------- state
    def _names(self):
        return [f"param_{i}" for i in range(len(self._parameter_list))]

    def state_dict(self) -> dict:
        name_of = {id(p): n for p, n in zip(self._parameter_list,
                                            self._names())}
        out = {}
        for acc_name, d in self._accumulators.items():
            for pid, val in d.items():
                out[f"{name_of.get(pid, pid)}__{acc_name}"] = val
        for pid, mw in self._master_weights.items():
            out[f"{name_of.get(pid, pid)}__master_weight"] = mw
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state: dict):
        by_name = dict(zip(self._names(), self._parameter_list))
        for key, val in state.items():
            if key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(val)
                continue
            if key == "@step":
                self._step_count = int(val)
                continue
            if "__" not in key:
                continue
            pname, acc_name = key.rsplit("__", 1)
            p = by_name.get(pname)
            if p is None:
                continue
            t = _state_tensor(val).to(device=p.device).clone()
            if acc_name == "master_weight":
                self._master_weights[id(p)] = t
            else:
                self._accumulators[acc_name][id(p)] = t
