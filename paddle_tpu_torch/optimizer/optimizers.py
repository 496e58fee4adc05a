"""The optimizers — the port of ``paddle_tpu/optimizer/optimizers.py``
(``:12-566``): SGD, Momentum, Adam, AdamW, Adamax, Adagrad, Adadelta,
RMSProp, Lamb, Lars, LBFGS, ASGD, Rprop, NAdam and RAdam.

``_update_param`` is the plain version, the reference's arithmetic in torch
ops on the parameter's device, in the reference's order, under its
accumulator names (the ``state_dict`` keys) and dtypes.  The reference
computes all but AdamW in jnp outside any Pallas kernel.  Where its jnp
promotion widens (a bfloat16 state times the float32 step count ``t`` or a
float32 trust ratio is float32 in JAX, bfloat16 in torch), ``_up`` widens
the operand first, so a bfloat16 parameter without master weights keeps
the reference's state dtypes: bfloat16 moments, and Lars's float32
velocity after its first step.  The reference's NAdam and RAdam write a
float32 update into such a parameter, which turns it float32; here the
parameter keeps its dtype and takes the update rounded.  Lamb's and Lars's
trust ratios stay device tensors (``torch.where``), so a ``TrainStep``
over them makes no host sync.  LBFGS runs through ``step(closure)`` and
reads floats on the host, as the reference's.  On CUDA, AdamW updates every parameter whose state is float32 (a
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
from .lr import LRScheduler
from .optimizer import _LOW_PRECISION, Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "Lamb", "Lars", "LBFGS", "ASGD", "Rprop",
           "NAdam", "RAdam"]


def _up(x: torch.Tensor) -> torch.Tensor:
    """``x`` as JAX promotes it against a float32 0-d array (the step count
    and what is made from it, a trust ratio): float16 and bfloat16 widen to
    float32, which torch's promotion of a 0-d tensor does not do."""
    return x.float() if x.dtype in _LOW_PRECISION else x


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x.astype(float32))`` over every element."""
    x = x.float()
    return torch.sqrt(torch.sum(x * x))


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        self._write_back(p, w - lr * grad.to(w.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_accumulators(self, p):
        self._acc("velocity", p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        v = self._momentum * self._acc("velocity", p) + grad
        self._set_acc("velocity", p, v)
        update = grad + self._momentum * v if self._nesterov else v
        self._write_back(p, w - lr * update.to(w.dtype))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

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
        return (_up(m) / (1 - self._beta1 ** t),
                _up(v) / (1 - self._beta2 ** t))

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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, p):
        self._acc("moment", p)
        self._acc("inf_norm", p)
        self._beta_pow(p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        t = self._beta_pow(p) + 1
        self._set_acc("beta_pow", p, t)
        m = self._beta1 * self._acc("moment", p) + (1 - self._beta1) * grad
        u = torch.maximum(self._beta2 * self._acc("inf_norm", p),
                          torch.abs(grad))
        self._set_acc("moment", p, m)
        self._set_acc("inf_norm", p, u)
        self._write_back(p, w - (lr / (1 - self._beta1 ** t) * _up(m)
                                 / (u + self._epsilon)).to(w.dtype))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _moment(self, p):
        return self._acc("moment", p, init=lambda: torch.full_like(
            self._master(p), self._init_acc))

    def _create_accumulators(self, p):
        self._moment(p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        acc = self._moment(p) + grad * grad
        self._set_acc("moment", p, acc)
        self._write_back(p, w - (lr * grad / (torch.sqrt(acc)
                                              + self._epsilon)).to(w.dtype))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, p):
        self._acc("avg_squared_grad", p)
        self._acc("avg_squared_update", p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        rho, eps = self._rho, self._epsilon
        avg_sq = (rho * self._acc("avg_squared_grad", p)
                  + (1 - rho) * grad * grad)
        avg_up = self._acc("avg_squared_update", p)
        update = torch.sqrt(avg_up + eps) / torch.sqrt(avg_sq + eps) * grad
        avg_up = rho * avg_up + (1 - rho) * update * update
        self._set_acc("avg_squared_grad", p, avg_sq)
        self._set_acc("avg_squared_update", p, avg_up)
        self._write_back(p, w - (lr * update).to(w.dtype))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, p):
        self._acc("mean_square", p)
        self._acc("momentum", p)
        if self._centered:
            self._acc("mean_grad", p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        rho = self._rho
        ms = rho * self._acc("mean_square", p) + (1 - rho) * grad * grad
        self._set_acc("mean_square", p, ms)
        if self._centered:
            mg = rho * self._acc("mean_grad", p) + (1 - rho) * grad
            self._set_acc("mean_grad", p, mg)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * self._acc("momentum", p) + lr * grad / denom
        self._set_acc("momentum", p, mom)
        self._write_back(p, w - mom.to(w.dtype))


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _create_accumulators(self, p):
        self._acc("moment1", p)
        self._acc("moment2", p)
        self._beta_pow(p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        b1, b2 = self._beta1, self._beta2
        t = self._beta_pow(p) + 1
        self._set_acc("beta_pow", p, t)
        m = b1 * self._acc("moment1", p) + (1 - b1) * grad
        v = b2 * self._acc("moment2", p) + (1 - b2) * grad * grad
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        mhat = _up(m) / (1 - b1 ** t)
        vhat = _up(v) / (1 - b2 ** t)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        wd = self._wd
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        update = r + wd * w
        w_norm, u_norm = _norm(w), _norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        self._write_back(p, w - (lr * trust * update).to(w.dtype))


class Lars(Momentum):
    """LARS (the reference's lars_momentum): Momentum with a layer-wise
    rate ``lars_coeff * |w| / (|g| + wd |w| + eps)``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=1e-9,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip, multi_precision)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._lars_eps = epsilon

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        w_norm, g_norm = _norm(w), _norm(grad)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm / (g_norm + self._lars_wd * w_norm
                                         + self._lars_eps),
            1.0)
        eff_lr = lr * local_lr
        grad = grad + self._lars_wd * w
        v = self._momentum * self._acc("velocity", p) + eff_lr * _up(grad)
        self._set_acc("velocity", p, v)
        self._write_back(p, w - v.to(w.dtype))


class LBFGS(Optimizer):
    """Limited-memory BFGS with the reference's backtracking Armijo line
    search.  ``step(closure)``: the closure clears nothing, computes the
    loss, calls ``backward()`` and returns the loss; the history is flat
    float32 vectors on the parameters' device, and the search reads its
    floats on the host, as the reference's."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False)
        self.max_iter = max_iter
        self.max_eval = (max_eval if max_eval is not None
                         else max_iter * 5 // 4)
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s_hist, self._y_hist, self._rho = [], [], []

    def _flat(self, grads=False) -> torch.Tensor:
        parts = []
        for p in self._parameter_list:
            v = ((p.grad if p.grad is not None else torch.zeros_like(p))
                 if grads else p)
            parts.append(v.detach().reshape(-1).float())
        return torch.cat(parts)

    @torch.no_grad()
    def _assign(self, flat: torch.Tensor):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.copy_(flat[off:off + n].reshape(p.shape).to(p.dtype))
            off += n

    def _eval(self, closure, x):
        self._assign(x)
        self.clear_grad()
        with torch.enable_grad():
            loss = closure()
        return float(loss.detach()), self._flat(grads=True)

    def _direction(self, g):
        q = g
        alphas = []
        for s, y, rho in zip(reversed(self._s_hist), reversed(self._y_hist),
                             reversed(self._rho)):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self._y_hist:
            y, s = self._y_hist[-1], self._s_hist[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for (s, y, rho), a in zip(zip(self._s_hist, self._y_hist, self._rho),
                                  reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return -q

    def step(self, closure=None):
        if closure is None:
            raise RuntimeError("LBFGS.step requires a closure that "
                               "recomputes the loss")
        self.clear_grad()
        with torch.enable_grad():
            loss0 = closure()
        loss = float(loss0.detach())
        x = self._flat()
        g = self._flat(grads=True)
        n_eval = 1
        lr = self._base_lr()
        for _ in range(self.max_iter):
            if float(torch.max(torch.abs(g))) <= self.tolerance_grad:
                break
            d = self._direction(g)
            gtd = float(torch.dot(g, d))
            if gtd > -1e-15:
                self._s_hist, self._y_hist, self._rho = [], [], []
                d = -g
                gtd = float(torch.dot(g, d))
            t = lr
            ok = False
            for _ls in range(20):
                new_loss, new_g = self._eval(closure, x + t * d)
                n_eval += 1
                if new_loss <= loss + 1e-4 * t * gtd:
                    ok = True
                    break
                t *= 0.5
                if n_eval >= self.max_eval:
                    break
            if not ok:
                self._assign(x)
                break
            s = t * d
            y = new_g - g
            sy = float(torch.dot(s, y))
            if sy > 1e-10:
                self._s_hist.append(s)
                self._y_hist.append(y)
                self._rho.append(1.0 / sy)
                if len(self._s_hist) > self.history_size:
                    self._s_hist.pop(0)
                    self._y_hist.pop(0)
                    self._rho.pop(0)
            x = x + s
            if abs(new_loss - loss) < self.tolerance_change:
                loss, g = new_loss, new_g
                break
            loss, g = new_loss, new_g
            if n_eval >= self.max_eval:
                break
        self._assign(x)
        self._step_count += 1
        return torch.tensor(loss, dtype=torch.float32)

    def _base_lr(self) -> float:
        lr = self._learning_rate
        if isinstance(lr, LRScheduler):
            return lr()
        return lr.get_lr() if hasattr(lr, "get_lr") else float(lr)


class ASGD(Optimizer):
    """Averaged SGD: a running average of the last ``batch_num``
    gradients."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._batch_num = max(int(batch_num), 1)

    def _create_accumulators(self, p):
        self._acc("d", p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        d = self._acc("d", p)
        d = d + (grad - d) / self._batch_num
        self._set_acc("d", p, d)
        self._write_back(p, w - lr * d.to(w.dtype))


class Rprop(Optimizer):
    """Resilient backprop: sign-based step sizes, full-batch semantics."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _step_size(self, p):
        lr0 = (0.001 if callable(self._learning_rate)
               else self._learning_rate)
        return self._acc("step_size", p, init=lambda: torch.full_like(
            self._master(p), float(lr0)))

    def _create_accumulators(self, p):
        self._acc("prev_grad", p)
        self._step_size(p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        prev = self._acc("prev_grad", p)
        step = self._step_size(p)
        sign = torch.sign(grad * prev)
        step = torch.where(
            sign > 0, torch.clamp(step * self._eta_pos, max=self._lr_max),
            torch.where(sign < 0,
                        torch.clamp(step * self._eta_neg, min=self._lr_min),
                        step))
        grad_eff = torch.where(sign < 0, 0.0, grad)
        self._set_acc("prev_grad", p, grad_eff)
        self._set_acc("step_size", p, step)
        self._write_back(p, w - torch.sign(grad_eff) * step)


class NAdam(Adam):
    """Nesterov Adam; the step count and the running product of the
    momentum schedule are device tensors (``beta_pow``, ``mu_prod``)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self._momentum_decay = momentum_decay

    def _mu_prod(self, p):
        return self._acc("mu_prod", p, init=lambda: torch.ones(
            (), dtype=torch.float32, device=p.device))

    def _create_accumulators(self, p):
        super()._create_accumulators(p)
        self._mu_prod(p)

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        t = self._beta_pow(p) + 1
        self._set_acc("beta_pow", p, t)
        b1, b2, psi = self._beta1, self._beta2, self._momentum_decay
        mu_t = b1 * (1 - 0.5 * 0.96 ** (t * psi))
        mu_t1 = b1 * (1 - 0.5 * 0.96 ** ((t + 1) * psi))
        prod = self._mu_prod(p) * mu_t
        self._set_acc("mu_prod", p, prod)
        m = b1 * self._acc("moment1", p) + (1 - b1) * grad
        v = b2 * self._acc("moment2", p) + (1 - b2) * grad * grad
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        m_hat = (mu_t1 * _up(m) / (1 - prod * mu_t1)
                 + (1 - mu_t) * _up(grad) / (1 - prod))
        v_hat = _up(v) / (1 - b2 ** t)
        self._write_back(p, w - lr * m_hat / (torch.sqrt(v_hat)
                                              + self._epsilon))


class RAdam(Adam):
    """Rectified Adam; the rectification is a ``torch.where`` on the
    device step count, so a ``TrainStep`` crosses the threshold with no
    host read."""

    def _update_param(self, p, grad, lr, weight_decay):
        w = self._master(p)
        if weight_decay:
            grad = grad + weight_decay * w
        t = self._beta_pow(p) + 1
        self._set_acc("beta_pow", p, t)
        b1, b2 = self._beta1, self._beta2
        m = b1 * self._acc("moment1", p) + (1 - b1) * grad
        v = b2 * self._acc("moment2", p) + (1 - b2) * grad * grad
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        m_hat = _up(m) / (1 - b1 ** t)
        rho_inf = 2.0 / (1 - b2) - 1
        rho_t = rho_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        v_hat = torch.sqrt(_up(v) / (1 - b2 ** t))
        safe_rho = torch.clamp(rho_t, min=4.0 + 1e-3)
        r = torch.sqrt((safe_rho - 4) * (safe_rho - 2) * rho_inf
                       / ((rho_inf - 4) * (rho_inf - 2) * safe_rho))
        rect = lr * r * m_hat / (v_hat + self._epsilon)
        plain = lr * m_hat
        self._write_back(p, w - torch.where(rho_t > 5.0, rect, plain))

