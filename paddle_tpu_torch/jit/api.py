"""``to_static`` and ``TrainStep`` — the port of ``paddle_tpu/jit/api.py``
(``InputSpec`` and the tree helpers ``:50-106``, ``StaticFunction`` /
``to_static`` ``:127-398``, ``TrainStep`` ``:411-699``) with the same call
surface.

**to_static.**  The reference traces a function once per guard key and
runs the compiled program after that.  ``StaticFunction`` keeps the
reference's guard keys (``_guards``: the input structure, each tensor's
shape, dtype and ``requires_grad``, the training flag, the AMP state and
grad mode) in ``_cache`` and runs:

- a key's first call eagerly under ``lazy_segments.BreakDetector``: a host
  read inside the function breaks the key (a warning, once, with the
  reference's message; ``full_graph=True`` raises instead), and the broken
  key runs eagerly from then on with ``last_segment_count`` the
  reference's segment count (``_fallback_keys``);
- a call that wants a gradient (grad mode on and a parameter or an input
  requiring one) eagerly under autograd: the reference's recomputed
  forward + backward gives the same gradients;
- a no-grad call on CUDA through one CUDA graph per key
  (``jit/graphs.py`` ``GraphCache``, weights watched: an in-place update
  of a parameter reaches the replay, a replaced parameter captures
  again); on the CPU eagerly.  A replay's outputs are copied out of the
  graph's buffers, so a caller keeps them past the next call.

Every call but a broken key's runs under a ``trace_state.TraceContext``
over a fresh key (``default_generator().next_key()``, as ``:284`` draws
it), a static input of the graph refilled at each replay: dropout draws
new masks each call, JAX's bits for the same seed.
``bucket_dynamic_batch`` pads dim 0 of the inputs whose ``InputSpec``
marks it dynamic to the next power of two and slices back every output
whose leading dim is the bucket (``:210-237``).  ``enable_to_static(False)``
(``jit/__init__.py``) runs every ``StaticFunction`` as its function.

**TrainStep.**  The reference compiles forward, gradients and the
optimizer update into one XLA program.  PyTorch runs eagerly: a step here
is ``loss_fn(model, *batch)`` inside the step's random context,
``loss.backward()``, the optimizer's own ``_step`` under ``torch.no_grad``
(its ``grad_clip`` per parameter group; AdamW: kernel B9), and the
gradients cleared.  Nothing in a step waits for the device: the loss comes
back as a tensor on it.

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

import functools
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..framework.random import default_generator, fold_in
from ..optimizer.optimizer import Skip
from . import lazy_segments, trace_state
from .graphs import GraphCache, module_tensors

__all__ = ["to_static", "not_to_static", "StaticFunction", "ignore_module",
           "TrainStep", "InputSpec"]

# jit.enable_to_static(False) runs every StaticFunction as its function
_to_static_enabled = True


class InputSpec:
    """paddle.static.InputSpec: a shape with None (or -1) for a dynamic
    dim, a dtype (a name such as "int32", or a torch dtype)."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = list(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient


# ---------------------------------------------------------------- tree utils
def flatten_tensors(obj) -> Tuple[List[torch.Tensor], Any]:
    """Flatten a nested (list / tuple / dict) structure, extracting its
    tensor leaves -> (tensors, spec)."""
    tensors: List[torch.Tensor] = []

    def rec(o):
        if isinstance(o, torch.Tensor):
            tensors.append(o)
            return ("__T__", len(tensors) - 1)
        if isinstance(o, (list, tuple)):
            return (type(o).__name__, [rec(x) for x in o])
        if isinstance(o, dict):
            return ("dict", {k: rec(v) for k, v in o.items()})
        return ("leaf", o)

    spec = rec(obj)
    return tensors, spec


def unflatten_tensors(spec, tensors: List):
    kind, payload = spec
    if kind == "__T__":
        return tensors[payload]
    if kind == "list":
        return [unflatten_tensors(s, tensors) for s in payload]
    if kind == "tuple":
        return tuple(unflatten_tensors(s, tensors) for s in payload)
    if kind == "dict":
        return {k: unflatten_tensors(v, tensors) for k, v in payload.items()}
    return payload


def _spec_signature(spec) -> Any:
    """Hashable structural signature of a flatten spec."""
    kind, payload = spec
    if kind == "__T__":
        return ("T", payload)
    if kind in ("list", "tuple"):
        return (kind, tuple(_spec_signature(s) for s in payload))
    if kind == "dict":
        return ("dict", tuple(sorted((k, _spec_signature(v))
                                     for k, v in payload.items())))
    try:
        hash(payload)
        return ("leaf", payload)
    except TypeError:
        return ("leaf", repr(payload))


class StaticFunction:
    """A function or layer under ``to_static`` (module docstring).
    ``_cache`` holds the keys that run whole (one CUDA graph each on
    CUDA), ``_fallback_keys`` the broken ones; ``_graphs`` (None: on for
    CUDA calls) and ``_graph_cache`` let the tests run the graph path on
    the CPU with a stand-in capture."""

    def __init__(self, function: Callable, input_spec=None,
                 build_strategy=None, backend=None, full_graph=False,
                 bucket_dynamic_batch=False, state_layer=None):
        self._layer: Optional[torch.nn.Module] = state_layer
        if isinstance(function, torch.nn.Module):
            self._layer = function
            self._fn = function.forward
        elif isinstance(getattr(function, "__self__", None),
                        torch.nn.Module):
            self._layer = function.__self__
            self._fn = function
        else:
            self._fn = function
        self._input_spec = input_spec
        self._bucket_dynamic_batch = bucket_dynamic_batch
        self._full_graph = full_graph
        self._cache: Dict[Any, List] = {}     # key -> its output structure
        self._fallback_keys: set = set()
        self._warned_fallback = False
        self._graphs: Optional[bool] = None
        self._graph_cache: Optional[GraphCache] = None
        self.last_segment_count: Optional[int] = None
        functools.update_wrapper(self, self._fn)

    # paddle surface
    @property
    def concrete_program(self):
        return None

    @property
    def _name(self) -> str:
        return getattr(self._fn, "__name__", "fn")

    def _state_tensors(self) -> List[torch.Tensor]:
        if self._layer is None:
            return []
        return list(self._layer.parameters()) + list(self._layer.buffers())

    def _guards(self, arg_tensors, spec, training):
        from ..amp.auto_cast import amp_state

        st = amp_state()
        return (_spec_signature(spec),
                tuple((tuple(t.shape), str(t.dtype), t.requires_grad)
                      for t in arg_tensors),
                training,
                (st.enabled, st.dtype, st.level),
                torch.is_grad_enabled())

    # -------------------------------------------- dynamic-dim bucket policy
    def _dynamic_batch_dims(self):
        """Arg indices whose InputSpec marks dim 0 dynamic (None / -1),
        where ``bucket_dynamic_batch`` is on (the reference's opt-in: the
        padding asserts that batch rows are independent, and every output
        whose leading dim is the bucket is sliced)."""
        if not self._input_spec or not self._bucket_dynamic_batch:
            return None
        dyn = [i for i, s in enumerate(self._input_spec)
               if isinstance(s, InputSpec) and s.shape
               and s.shape[0] in (None, -1)]
        return dyn or None

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return b

    def _device(self, tensors) -> torch.device:
        for t in self._state_tensors() + list(tensors):
            return t.device
        return torch.device("cpu")

    def _run_segmented(self, args, kwargs):
        out, det = lazy_segments.run_segmented(self._fn, args, kwargs,
                                               name=self._name)
        self.last_segment_count = det.segments
        return out

    def _first_call(self, key, args, kwargs, rng_key):
        """A key's first call: eager under the break detector.  A read on
        the host breaks the key (or raises with ``full_graph``)."""
        with trace_state.activate(trace_state.TraceContext(rng_key)):
            out, det = lazy_segments.run_segmented(
                self._fn, args, kwargs, name=self._name,
                strict=self._full_graph)
        if det.breaks:
            self._fallback_keys.add(key)
            self.last_segment_count = det.segments
            if not self._warned_fallback:
                self._warned_fallback = True
                warnings.warn(
                    f"to_static({self._name}): graph break "
                    f"({det.breaks[0]}); splitting this input signature "
                    "into compiled segments at host reads. Pass "
                    "full_graph=True to error instead.")
            return out
        self._cache[key] = flatten_tensors(out)[1]
        return out

    def _graph_run(self, key, spec, tensors, rng_key, device):
        """A no-grad call of a whole key through its CUDA graph: the key's
        random key and its inputs are the graph's static inputs."""
        if self._graph_cache is None:
            from ..ops.hopper import launch_counters

            self._graph_cache = GraphCache(
                device, counters=launch_counters,
                weights=(None if self._layer is None
                         else module_tensors(self._layer)))
        cache = self._graph_cache
        cache.watch()
        fresh = key not in cache.graphs

        def run(k, *xs):
            args, kwargs = unflatten_tensors(spec, list(xs))
            with trace_state.activate(trace_state.TraceContext(k)):
                out = self._fn(*args, **kwargs)
            return flatten_tensors(out)[0]

        outs = cache.run(key, run, [rng_key, *tensors])
        # a replay hands back the graph's own buffers, rewritten by the
        # next replay
        return outs if fresh else [o.clone() for o in outs]

    def __call__(self, *args, **kwargs):
        if not _to_static_enabled or lazy_segments.active():
            # jit.enable_to_static(False), or a call inside another
            # to_static function's run: inline
            return self._fn(*args, **kwargs)
        training = self._layer.training if self._layer is not None else True
        tensors, spec = flatten_tensors((args, kwargs))

        dyn = self._dynamic_batch_dims()
        real_n = bucket = None
        if dyn and not kwargs and len(args) >= len(self._input_spec):
            real_n = int(tensors[dyn[0]].shape[0])
            bucket = self._bucket(real_n)
            if bucket == real_n:
                real_n = None        # an exact bucket: nothing to slice back
            else:
                tensors = [torch.cat([t, t.new_zeros(
                    (bucket - t.shape[0], *t.shape[1:]))])
                    if i in dyn else t for i, t in enumerate(tensors)]
                args, kwargs = unflatten_tensors(spec, tensors)

        key = self._guards(tensors, spec, training)
        if key in self._fallback_keys:
            return self._run_segmented(args, kwargs)
        device = self._device(tensors)
        rng_key = default_generator().next_key(device)
        wants_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in self._state_tensors() + tensors)
        graphs = (self._graphs if self._graphs is not None
                  else device.type == "cuda")
        if key not in self._cache:
            out = self._first_call(key, args, kwargs, rng_key)
        elif graphs and not wants_grad:
            out = unflatten_tensors(
                self._cache[key],
                self._graph_run(key, spec, tensors, rng_key, device))
        else:
            with trace_state.activate(trace_state.TraceContext(rng_key)):
                out = self._fn(*args, **kwargs)
        if real_n is not None:
            out_tensors, out_spec = flatten_tensors(out)
            out = unflatten_tensors(out_spec, [
                t[:real_n] if t.dim() >= 1 and t.shape[0] == bucket else t
                for t in out_tensors])
        return out


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator / wrapper, as paddle.jit.to_static.  ``full_graph=False``
    (default) runs a signature whose function reads a tensor on the host
    eagerly, segment count kept (a graph break); ``full_graph=True``
    raises instead."""

    def decorate(fn):
        return StaticFunction(
            fn, input_spec=input_spec, build_strategy=build_strategy,
            backend=backend, full_graph=kwargs.get("full_graph", False),
            bucket_dynamic_batch=kwargs.get("bucket_dynamic_batch", False),
            state_layer=kwargs.get("state_layer"))

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn=None):
    if fn is None:
        return lambda f: f
    return fn


def ignore_module(modules):
    return None


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
