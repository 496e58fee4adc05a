"""Static control flow — the port of ``paddle_tpu/static/nn/control_flow.py``
(``cond``, ``while_loop``, ``case``, ``switch_case``, ``static_pylayer``,
``py_func``).

The reference lowers a branch or a loop to ``lax.cond`` /
``lax.while_loop`` inside its one compiled program.  The port's Executor
replays a program op by op, so:

1. eager, with a concrete predicate or concrete loop variables, each is
   Python: the branch taken runs, the loop iterates;
2. in a recorded program (``enable_static()``, a program variable as the
   predicate or among the loop variables), each branch, the loop's
   condition and its body are recorded as sub-programs (``_Branch``: their
   ops, the variables they read from outside, their outputs), and ONE op
   is recorded that runs the chosen branch, or the loop, when the program
   is replayed.  It reads its predicate on the host, so a program holding
   it replays eagerly (never inside a CUDA graph).  A loop variable is a
   variable of the sub-programs whatever it was given as, so a concrete
   counter counts at each replay (the reference folds a concrete
   counter's condition while it records: its ``max_iters`` loop over
   ``(zeros, v)`` runs ``max_iters`` times; ROADMAP lists the
   divergence).

Gradients flow through the branch taken and the iterations run, as autograd
records them at the replay; ``max_iters`` bounds the iterations (the
reference needs it to differentiate the loop, here it is only a bound).
``static_pylayer`` takes a user backward through a
``torch.autograd.Function``, ``py_func`` runs host Python on numpy arrays
(its ``backward_func`` too).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ... import static as st

__all__ = ["cond", "while_loop", "case", "switch_case", "static_pylayer",
           "py_func"]


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _flatten(out):
    """A nest of tensors (tuple / list / dict) -> (tensor leaves, spec);
    Python numbers become tensors."""
    leaves, spec = tree_flatten(out)
    return [_as_tensor(x) for x in leaves], spec


def _truth(v: torch.Tensor) -> bool:
    return bool(v.reshape(()))


class _Branch:
    """``fn(*args)`` recorded into a sub-program of its own: its ops, its
    outputs and the variables it reads from outside (``externals``: read
    or returned, neither made in it nor among ``args``)."""

    def __init__(self, fn: Callable, args: Sequence[torch.Tensor] = ()):
        self.args = list(args)
        sub = st.Program()
        with st.program_guard(sub):
            out = fn(*self.args)
        self.ops = sub.ops
        self.out_ts, self.spec = _flatten(out)
        inner = {id(o) for _, _, outs, _ in self.ops for o in outs}
        inner.update(id(a) for a in self.args)
        self.externals: List[torch.Tensor] = []
        seen = set()
        for t in [t for _, ins, _, _ in self.ops for t in ins] + self.out_ts:
            if (id(t) not in inner and id(t) not in seen
                    and st.is_variable(t)):
                seen.add(id(t))
                self.externals.append(t)

    def run(self, env: dict) -> List[torch.Tensor]:
        """The branch's outputs over ``env`` (variable id -> tensor)."""
        env = st.replay(self.ops, dict(env))
        return [env.get(id(t), t) for t in self.out_ts]

    def new_outputs(self) -> List[torch.Tensor]:
        return [st.fake_like(t.shape, t.dtype, t.device)
                for t in self.out_ts]


def _merge_externals(*branches: _Branch) -> List[torch.Tensor]:
    ext, seen = [], set()
    for b in branches:
        for t in b.externals:
            if id(t) not in seen:
                seen.add(id(t))
                ext.append(t)
    return ext


def _check_same_structure(a: _Branch, b: _Branch, what: str):
    if a.spec != b.spec or len(a.out_ts) != len(b.out_ts):
        raise ValueError(f"{what}: branch outputs must have identical "
                         f"structure ({a.spec} vs {b.spec})")
    for x, y in zip(a.out_ts, b.out_ts):
        if tuple(x.shape) != tuple(y.shape):
            raise ValueError(f"{what}: branch output shapes differ: "
                             f"{tuple(x.shape)} vs {tuple(y.shape)}")


# --------------------------------------------------------------------- cond
def cond(pred, true_fn: Callable = None, false_fn: Callable = None,
         name=None, return_names=None):
    """Run ``true_fn()`` when ``pred`` holds, else ``false_fn()``; in a
    recorded program both must return the same structure of shapes."""
    if st.is_variable(pred):
        tb, fb = _Branch(true_fn), _Branch(false_fn)
        _check_same_structure(tb, fb, "cond")
        ext = _merge_externals(tb, fb)

        def cond_op(p, *ext_vals):
            env = {id(t): v for t, v in zip(ext, ext_vals)}
            return tuple((tb if _truth(p) else fb).run(env))

        outs = tb.new_outputs()
        st.record(cond_op, [pred, *ext], outs, "cond", host=True)
        return tree_unflatten(outs, tb.spec)
    fn = true_fn if _truth(_as_tensor(pred)) else false_fn
    return None if fn is None else fn()


# --------------------------------------------------------------- while_loop
def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars,
               is_test=False, name=None, max_iters: Optional[int] = None):
    """Iterate ``body_fn`` while ``cond_fn`` holds (at most ``max_iters``
    times when given); the body returns the structure of ``loop_vars``."""
    var_ts, spec = _flatten(loop_vars)
    if st._static_enabled() and any(st.is_variable(t) for t in var_ts):
        args = [st.fake_like(t.shape, t.dtype, t.device) for t in var_ts]
        cb = _Branch(lambda *a: cond_fn(*tree_unflatten(list(a), spec)),
                     args)
        bb = _Branch(lambda *a: body_fn(*tree_unflatten(list(a), spec)),
                     args)
        if bb.spec != spec or len(bb.out_ts) != len(var_ts):
            raise ValueError("while_loop: body must return the same "
                             "structure as loop_vars")
        ext = _merge_externals(cb, bb)
        n = len(var_ts)

        def while_op(*vals):
            carry = list(vals[:n])
            base = {id(t): v for t, v in zip(ext, vals[n:])}

            def env():
                e = dict(base)
                e.update({id(a): v for a, v in zip(args, carry)})
                return e

            it = 0
            while ((max_iters is None or it < max_iters)
                   and _truth(cb.run(env())[0])):
                carry = bb.run(env())
                it += 1
            return tuple(carry)

        outs = [st.fake_like(t.shape, t.dtype, t.device) for t in var_ts]
        st.record(while_op, [*var_ts, *ext], outs, "while_loop", host=True)
        return tree_unflatten(outs, spec)
    vars_now = tree_unflatten(var_ts, spec)
    it = 0
    while ((max_iters is None or it < max_iters)
           and _truth(_as_tensor(cond_fn(*vars_now)))):
        ts, s = _flatten(body_fn(*vars_now))
        if s != spec:
            raise ValueError("while_loop: body must return the same "
                             "structure as loop_vars")
        vars_now = tree_unflatten(ts, s)
        it += 1
    return vars_now


# --------------------------------------------------------------------- case
def case(pred_fn_pairs, default: Optional[Callable] = None, name=None):
    """The first pair whose predicate holds runs; without ``default`` the
    last pair's fn is the default.  A chain of ``cond``s."""
    pairs = list(pred_fn_pairs)
    if not pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")
    for p in pairs:
        if not (isinstance(p, (tuple, list)) and len(p) == 2
                and callable(p[1])):
            raise TypeError("case: each element must be a (pred, fn) pair")
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]
        if not pairs:
            return default()
    pred, fn = pairs[0]
    rest = pairs[1:]
    if rest:
        return cond(pred, fn, lambda: case(rest, default))
    return cond(pred, fn, default)


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name=None):
    """Dispatch on an integer index; ``branch_fns`` a dict {int: fn}, a
    list of (int, fn) or a list of fns (keys 0..n-1); the highest key is
    the fallback when ``default`` is None."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        items = sorted((int(k), f) for k, f in branch_fns)
    else:
        items = list(enumerate(branch_fns))
    if not items:
        raise ValueError("switch_case: branch_fns must be non-empty")
    if default is None:
        default = items[-1][1]
    idx = _as_tensor(branch_index)
    return case([(torch.eq(idx, k), fn) for k, fn in items], default)


# ------------------------------------------------------------ static_pylayer
class _PyLayer(torch.autograd.Function):
    """``run(*vals)`` forward, ``backward_fn(*grads)`` backward for the
    first ``n_in`` values (the rest, a branch's externals, get none)."""

    @staticmethod
    def forward(ctx, run, backward_fn, n_in, *vals):
        ctx.backward_fn, ctx.n_in, ctx.n_vals = backward_fn, n_in, len(vals)
        return tuple(run(*vals))

    @staticmethod
    def backward(ctx, *gs):
        gin, _ = _flatten(ctx.backward_fn(*gs))
        return (None, None, None, *gin[:ctx.n_in],
                *[None] * (ctx.n_vals - ctx.n_in))


def static_pylayer(forward_fn: Callable, inputs: Sequence,
                   backward_fn=None, name=None):
    """``forward_fn(*inputs)`` with ``backward_fn`` (the output gradients
    -> the input gradients) as its backward; without one the outputs carry
    no gradient."""
    ins = [_as_tensor(x) for x in inputs]
    if backward_fn is None:
        ts, spec = _flatten(forward_fn(*ins))
        return tree_unflatten([t.detach() for t in ts], spec)
    if any(st.is_variable(t) for t in ins):
        args = [st.fake_like(t.shape, t.dtype, t.device) for t in ins]
        br = _Branch(forward_fn, args)
        ext = br.externals
        n = len(ins)

        def run(*vals):
            env = {id(a): v for a, v in zip(args + ext, vals)}
            return br.run(env)

        def op(*vals):
            return _PyLayer.apply(run, backward_fn, n, *vals)

        outs = br.new_outputs()
        st.record(op, [*ins, *ext], outs, "static_pylayer")
        return tree_unflatten(outs, br.spec)
    spec = []

    def run(*vals):
        ts, s = _flatten(forward_fn(*vals))
        spec.append(s)
        return ts

    outs = _PyLayer.apply(run, backward_fn, len(ins), *ins)
    return tree_unflatten(list(outs), spec[0])


# ------------------------------------------------------------------- py_func
def py_func(func: Callable, x, out, backward_func=None,
            skip_vars_in_backward_input=None, name=None):
    """Host Python inside the program: ``func`` takes numpy arrays and
    returns arrays shaped as ``out`` (a tensor or a list: the results'
    shapes and dtypes); ``backward_func`` maps the output gradients to the
    input gradients, as arrays.  Returns a tensor, or a list for a list
    ``out``."""
    ins = [_as_tensor(t) for t in (x if isinstance(x, (list, tuple))
                                   else [x])]
    out_list = list(out) if isinstance(out, (list, tuple)) else [out]
    specs = [(tuple(t.shape), t.dtype) for t in out_list]
    dev = ins[0].device if ins else out_list[0].device

    def host(fn, arrays, shapes):
        res = fn(*[st._numpy(a) for a in arrays])
        rs = res if isinstance(res, (tuple, list)) else [res]
        return [torch.as_tensor(np.asarray(r)).to(dt).reshape(shape).to(dev)
                for r, (shape, dt) in zip(rs, shapes)]

    def op(*vals):
        if backward_func is None:
            return tuple(host(func, vals, specs))
        grads = [(tuple(t.shape), t.dtype) for t in vals]
        return _PyLayer.apply(
            lambda *vs: host(func, vs, specs),
            lambda *gs: host(backward_func, gs, grads), len(vals), *vals)

    if any(st.is_variable(t) for t in ins):
        outs = [st.fake_like(shape, dt, dev) for shape, dt in specs]
        st.record(op, ins, outs, "py_func", host=True)
    else:
        outs = list(op(*ins))
    return outs[0] if len(outs) == 1 else outs
