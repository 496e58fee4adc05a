"""``paddle.static`` — the port of ``paddle_tpu/static/__init__.py``.

The reference records a ``Program`` at its one dispatch chokepoint: under
``enable_static()`` an op with a symbolic input is appended to the current
program as (fn, inputs, outputs, name) and returns abstract outputs
(``_capture``), and ``Executor.run`` replays the op list as one jitted
function.  The port's chokepoint is PyTorch's dispatcher:

- **The recorder.**  ``enable_static()`` pushes ``_Recorder``, a
  ``TorchDispatchMode`` (the mechanism of ``jit/lazy_segments.py``'s
  ``BreakDetector``), which sees every aten op and every kernel op
  (``paddle_tpu_torch::rms_norm`` and its siblings, one op per kernel
  call).  An op whose inputs include a program variable is appended to
  ``default_main_program()`` as ``(_Call, inputs, outputs, name)`` and
  returns outputs computed by a ``FakeTensorMode``: tensors with a shape,
  a dtype and a device and no memory.  An op on concrete tensors alone
  runs as it does eagerly.  Where it reads a parameter (or a tensor so
  derived), its result is not frozen into the program: the recorder notes
  how it was derived (``_Derived``), and the first recorded op that reads
  it pulls that derivation into the program before itself, so a replay
  computes it again from the parameters as they are then (a tied head's
  ``weight.t()``, the decode step's q/k/v concatenation), and training
  and in-place weight loads reach it.  Other concrete results (tables,
  masks) are constants of the program, as in the reference.  An op with a
  program variable among its inputs takes no AMP cast
  (``amp.auto_cast``'s ``_recorded``), as the reference records it before
  its cast.  The fake-tensor machinery is imported at the first
  ``enable_static()`` or ``data()``, never at the package's import.
- **Checkpointed regions.**  Ops recorded inside a
  ``torch.utils.checkpoint`` call (``config.recompute``'s layers,
  ``pretraining_loss``'s chunks) are tagged with the call; a training
  replay runs each such run of ops through ``checkpoint`` again
  (``_Region``), so their activations are rebuilt in the backward, as in
  the eager model; a no-grad replay runs them flat.
- **Placeholders.**  ``data(name, shape, dtype)`` is such a fake tensor on
  the program's device, so the kernel wrappers (the plain version for CPU
  tensors, the kernel for CUDA ones) take the branch the fed run takes:
  the device is ``device=``, else ``device_guard``'s, else the card
  (``device.resolve_device``: without CUDA that raises; the tests ask for
  ``"cpu"``).  A dim of None or -1 is recorded at 1.
- **Host reads.**  ``item()``, ``bool()``, a copy to the CPU and
  ``numpy()`` / ``tolist()`` of a program variable raise ``RuntimeError``
  naming the op (``BreakDetector``'s read detection), as the reference's
  concretization error does; so do an in-place write of a variable into a
  concrete tensor, and an op the fake mode cannot shape.
- **The Executor.**  ``Executor.run`` replays the op list on the fed
  tensors, each op the recorded aten or kernel op (the same kernels and
  launches as the eager forward).  ``_cache`` is keyed as the reference's
  (program, op count, feed names and shapes, fetches).  A program without
  ``minimize`` replays under ``torch.no_grad``; on CUDA, unless an op reads
  the host (``cond``, ``while_loop``, ``py_func``, ``Print``), through one
  ``jit/graphs.py`` ``GraphCache`` graph per key (its first run eager,
  then captured; the program's concrete tensors watched, so an in-place
  update reaches the replay and a replaced tensor captures again).  A
  program marked by ``optimizer.minimize(loss)`` replays under autograd,
  ``loss.backward()`` (the kernel ops' backwards are registered on the ops:
  ``ops/hopper/_build.py`` ``autograd_op``), then the optimizer's own
  ``step()`` and ``clear_grad()`` (``_run_train``).  A replay lets go of
  each value after its last reader (``_Plan.drops``).  Nothing is
  recorded while ``Executor.run`` or ``save_inference_model`` runs.

``Program.bind(var, value)`` pins a variable to a value (the reference's
tests set a placeholder's ``_value``), which ``ConstantFoldingPass``
folds.  Control flow is ``static/nn/control_flow.py``, the passes
``static/passes.py``.  ``create_parameter`` with an initializer waits for
``nn.initializer`` (ROADMAP A10a); the IPU backend raises, as in the
reference.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import json
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint
from torch.utils.weak import WeakIdKeyDictionary

from ..device import resolve_device
from ..jit.api import InputSpec
from ..jit.lazy_segments import _SCALAR_READS, _ArrayReads, _to_cpu_read
from .passes import (  # noqa: F401
    CommonSubexpressionEliminationPass,
    ConstantFoldingPass,
    DeadCodeEliminationPass,
    PassBase,
    PassManager,
    print_program,
    program_to_str,
)

__all__ = [
    "Program", "program_guard", "default_main_program",
    "default_startup_program", "data", "Executor", "scope_guard",
    "global_scope", "name_scope", "save_inference_model",
    "load_inference_model", "InputSpec", "Variable", "cpu_places",
    "cuda_places", "xpu_places", "device_guard", "BuildStrategy",
    "CompiledProgram", "ExponentialMovingAverage", "create_global_var",
    "create_parameter", "gradients", "append_backward", "accuracy",
    "Print", "save", "load", "load_program_state", "set_program_state",
    "serialize_program", "serialize_persistables",
    "deserialize_persistables", "PassBase", "PassManager",
    "DeadCodeEliminationPass", "CommonSubexpressionEliminationPass",
    "ConstantFoldingPass", "print_program", "program_to_str",
]

Variable = torch.Tensor

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(np.dtype(dtype)) if not isinstance(dtype, str) else dtype
    if name not in _DTYPES:
        raise ValueError(f"static: unsupported dtype {dtype!r}")
    return _DTYPES[name]


def __getattr__(name):
    # static.nn imports nn.functional and the control flow on first use
    if name == "nn":
        import importlib

        mod = importlib.import_module(__name__ + ".nn")
        globals()["nn"] = mod
        return mod
    raise AttributeError(name)


# ------------------------------------------------------- fake tensors
_fake: Dict[str, Any] = {"mode": None, "cls": None}


def _fake_mode():
    """The static world's ``FakeTensorMode`` (imported and made on first
    use); concrete inputs of an op are taken as fakes of themselves."""
    if _fake["mode"] is None:
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

        _fake["cls"] = FakeTensor
        _fake["mode"] = FakeTensorMode(allow_non_fake_inputs=True)
    return _fake["mode"]


def is_variable(t) -> bool:
    """Whether ``t`` is a program variable: a placeholder or an output of a
    recorded op (a fake tensor of the static world's mode; not a concrete
    tensor, nor another tracer's fake, as ``torch.export``'s)."""
    cls = _fake["cls"]
    return (cls is not None and isinstance(t, cls)
            and t.fake_mode is _fake["mode"])


def fake_like(shape, dtype, device) -> torch.Tensor:
    """A new program variable of this shape, dtype and device."""
    with _fake_mode():
        return torch.empty(tuple(shape), dtype=dtype, device=device)


# ------------------------------------------------------------ program
class Program:
    """A recorded op list with its feeds (the reference's ``Program``):
    ``ops`` holds (fn, inputs, outputs, name), fn a callable of the input
    tensors; ``_loss`` / ``_optimizer`` are set by ``minimize``;
    ``_values`` maps a bound variable's id to (variable, value),
    ``_names`` a placeholder's id to its feed name (a tensor's ``name``
    is PyTorch's, read-only)."""

    _ids = itertools.count()

    def __init__(self):
        self.id = next(Program._ids)
        self.ops: List[tuple] = []
        self.feeds: List[torch.Tensor] = []
        self._loss: Optional[torch.Tensor] = None
        self._optimizer = None
        self._values: Dict[int, tuple] = {}
        self._names: Dict[int, str] = {}
        # id(_Derived) -> (node, its outputs' tensors in this program)
        self._pulled: Dict[int, tuple] = {}
        self.random_seed = 0

    def global_block(self):
        return self

    def all_parameters(self) -> List[torch.nn.Parameter]:
        seen, out = set(), []
        for _, ins, _, _ in self.ops:
            for t in ins:
                if isinstance(t, torch.nn.Parameter) and id(t) not in seen:
                    seen.add(id(t))
                    out.append(t)
        return out

    def clone(self, for_test=False):
        p = Program()
        p.ops = list(self.ops)
        p.feeds = list(self.feeds)
        p._values = dict(self._values)
        p._names = dict(self._names)
        p._pulled = dict(self._pulled)
        return p

    def bind(self, var: torch.Tensor, value) -> None:
        """Pin the variable ``var`` to a concrete value (a feed frozen to a
        constant): runs need no feed for it and ``ConstantFoldingPass``
        folds what it alone computes."""
        v = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value).to(var.device)
        self._values[id(var)] = (var, v)

    def name_of(self, var: torch.Tensor) -> Optional[str]:
        """A placeholder's feed name (None for another tensor)."""
        return self._names.get(id(var))

    @property
    def feed_names(self) -> List[str]:
        return [self._names[id(t)] for t in self.feeds]

    def value_of(self, var: torch.Tensor) -> Optional[torch.Tensor]:
        hit = self._values.get(id(var))
        return None if hit is None else hit[1]

    def __str__(self):
        return program_to_str(self)

    def __repr__(self):
        return (f"Program(id={self.id}, ops={len(self.ops)}, "
                f"feeds={len(self.feeds)})")


_default_main = Program()
_default_startup = Program()
_prog_stack: List[Program] = []


def default_main_program() -> Program:
    return _prog_stack[-1] if _prog_stack else _default_main


def default_startup_program() -> Program:
    return _default_startup


class program_guard:
    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        _prog_stack.append(self.main)
        return self.main

    def __exit__(self, *exc):
        _prog_stack.pop()
        return False


# ----------------------------------------------------------- recording
class _Call:
    """One recorded aten or kernel op: ``func`` over the recorded argument
    tree, its tensors replaced by the call's."""

    __slots__ = ("func", "spec", "leaves", "slots", "region")

    def __init__(self, func, spec, leaves, region=None):
        self.func = func
        self.spec = spec
        # the ``torch.utils.checkpoint`` call it was recorded in, or None
        self.region = region
        self.slots = [i for i, x in enumerate(leaves)
                      if isinstance(x, torch.Tensor)]
        self.leaves = [None if isinstance(x, torch.Tensor) else x
                       for x in leaves]

    def in_region(self, region) -> "_Call":
        """This call, tagged with the checkpoint ``region``."""
        c = _Call.__new__(_Call)
        c.func, c.spec, c.leaves, c.slots = (self.func, self.spec,
                                             self.leaves, self.slots)
        c.region = region
        return c

    def __call__(self, *tensors):
        leaves = list(self.leaves)
        for i, t in zip(self.slots, tensors):
            leaves[i] = t
        args, kwargs = tree_unflatten(leaves, self.spec)
        return self.func(*args, **kwargs)

    @property
    def mutated(self) -> List[int]:
        """Positions (among the call's tensors) the op writes in place:
        the leaves of each schema argument marked as written (``self`` of
        ``add_``, ``out=``)."""
        schema = getattr(self.func, "_schema", None)
        if schema is None or not schema.is_mutable:
            return []
        # the argument tree with each leaf replaced by its index
        args, kwargs = tree_unflatten(list(range(len(self.leaves))),
                                      self.spec)
        written = set()
        for j, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            arg = args[j] if j < len(args) else kwargs.get(a.name)
            written.update(tree_leaves(arg))
        return [k for k, i in enumerate(self.slots) if i in written]

    def cse_key(self):
        """A value key for common subexpression elimination, or None for
        an op that must not merge (random, or writing in place)."""
        if (torch.Tag.nondeterministic_seeded in getattr(self.func, "tags",
                                                         ())
                or self.mutated):
            return None
        try:
            consts = tuple(self.leaves)
            hash(consts)
        except TypeError:
            consts = repr(self.leaves)
        return (self.func, str(self.spec), consts)


def outputs_of(res) -> List[torch.Tensor]:
    return [t for t in tree_leaves(res) if isinstance(t, torch.Tensor)]


def record(fn: Callable, inputs: Sequence[torch.Tensor],
           outputs: Sequence[torch.Tensor], name: str,
           host: bool = False) -> None:
    """Append one op to the current program; ``host``: the op reads its
    inputs on the host (a predicate, a Python callback), so a program
    holding it replays eagerly."""
    if host:
        fn.host = True
    default_main_program().ops.append((fn, list(inputs), list(outputs),
                                       name))


def _checkpoint_region():
    """The ``torch.utils.checkpoint`` call (non-reentrant) running now, as
    the pack hook it pushed, or None."""
    top_hooks = getattr(torch._C._autograd,
                        "_top_saved_tensors_default_hooks", None)
    top = None if top_hooks is None else top_hooks(False)
    if top is None or not getattr(top[0], "__qualname__", "").startswith(
            "_checkpoint_hook."):
        return None
    return top[0]


class _Derived:
    """How a concrete result of an op run while static mode is on came
    from parameters: the op, its inputs (a tensor, or (node, index) for an
    input derived in turn) and its outputs (held weakly, with their shape,
    dtype and device)."""

    __slots__ = ("call", "ins", "refs", "metas", "name", "__weakref__")

    def __init__(self, call, ins, outs, name):
        self.call, self.ins, self.name = call, ins, name
        self.refs = [weakref.ref(o) for o in outs]
        self.metas = [(tuple(o.shape), o.dtype, o.device) for o in outs]


# a derived concrete tensor -> (its _Derived, its output index)
_derived = WeakIdKeyDictionary()


def _pull(program: Program, node: _Derived, region) -> List[torch.Tensor]:
    """Record ``node`` (after the nodes it reads) into ``program`` once;
    -> the tensors that stand for its outputs there (the outputs, or a
    program variable for one no longer alive)."""
    hit = program._pulled.get(id(node))
    if hit is not None:
        return hit[1]
    ins = [_pull(program, e[0], region)[e[1]] if isinstance(e, tuple)
           else e for e in node.ins]
    outs = [r() if r() is not None else fake_like(*m)
            for r, m in zip(node.refs, node.metas)]
    program.ops.append((node.call.in_region(region), ins, outs, node.name))
    program._pulled[id(node)] = (node, outs)
    return outs


class _Recorder(TorchDispatchMode):
    """The static chokepoint (module docstring)."""

    def _constant(self, t) -> bool:
        return not is_variable(t)

    def _read(self, what: str):
        raise RuntimeError(
            f"static: {what} reads a program variable on the host; a "
            "Program runs on the device when Executor.run replays it, so "
            "its values are not known while it is recorded")

    def _eager(self, func, leaves, spec, args, kwargs):
        """An op on concrete tensors: run it, and note how its results
        came from parameters where they did (``_Derived``)."""
        out = func(*args, **kwargs)
        ts = [t for t in leaves if isinstance(t, torch.Tensor)]
        if func._schema.is_mutable:
            # a derived tensor written in place holds what it was given
            # now: a constant
            if any(t in _derived for t in ts):
                call = _Call(func, spec, leaves)
                for k in call.mutated:
                    _derived.pop(ts[k], None)
            return out
        if getattr(_static, "paused", 0) or not any(
                isinstance(t, torch.nn.Parameter) or t in _derived
                for t in ts):
            return out
        outs = outputs_of(out)
        if outs:
            node = _Derived(_Call(func, spec, leaves),
                            [_derived.get(t, t) for t in ts], outs,
                            str(func))
            for i, o in enumerate(outs):
                _derived[o] = (node, i)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves, spec = tree_flatten((args, kwargs))
        if not any(is_variable(t) for t in leaves):
            return self._eager(func, leaves, spec, args, kwargs)
        if func in _SCALAR_READS or _to_cpu_read(func, args, kwargs):
            self._read(str(func))
        try:
            with _fake_mode():
                out = func(*args, **kwargs)
        except Exception as e:
            raise RuntimeError(f"static: cannot record {func}: "
                               f"{type(e).__name__}: {e}") from e
        outs = outputs_of(out)
        if not outs:
            return out
        region = _checkpoint_region()
        call = _Call(func, spec, leaves, region)
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        for k in call.mutated:
            if not is_variable(ins[k]):
                raise RuntimeError(
                    f"static: {func} writes program variables into a "
                    "concrete tensor in place; a Program cannot record it")
        prog = default_main_program()
        for i, t in enumerate(ins):
            hit = None if is_variable(t) else _derived.get(t)
            if hit is not None:
                ins[i] = _pull(prog, hit[0], region)[hit[1]]
        record(call, ins, outs, str(func))
        return out


_static = threading.local()


def _enable():
    if getattr(_static, "modes", None):
        return
    _fake_mode()
    rec = _Recorder()
    reads = _ArrayReads(rec)
    reads.__enter__()
    rec.__enter__()
    _static.modes = (reads, rec)


def _disable():
    modes = getattr(_static, "modes", None)
    if not modes:
        return
    reads, rec = modes
    rec.__exit__(None, None, None)
    reads.__exit__(None, None, None)
    _static.modes = None


def _static_enabled() -> bool:
    return bool(getattr(_static, "modes", None))


@contextlib.contextmanager
def _paused():
    """Run eagerly with nothing noted or recorded (an Executor's replay,
    the optimizer's step, an export)."""
    _static.paused = getattr(_static, "paused", 0) + 1
    try:
        yield
    finally:
        _static.paused -= 1


# ------------------------------------------------------------- devices
_device_stack: List[torch.device] = []


def _default_device(device=None) -> torch.device:
    if device is not None:
        return resolve_device(_place_device(device))
    if _device_stack:
        return _device_stack[-1]
    return resolve_device(None)


def _place_device(place):
    """A place ("cpu", "gpu", "gpu:1", "cuda", a torch.device) as a torch
    device name."""
    if isinstance(place, torch.device):
        return place
    s = str(place).lower()
    if s.startswith("gpu"):
        s = "cuda" + s[3:]
    return s


class device_guard:
    """Variables and global variables made inside take ``device`` ("cpu",
    "gpu", "gpu:0", "cuda"); None keeps the enclosing choice."""

    def __init__(self, device=None):
        self.device = None if device is None else resolve_device(
            _place_device(device))

    def __enter__(self):
        if self.device is not None:
            _device_stack.append(self.device)
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            _device_stack.pop()
        return False


def cpu_places(device_count=None):
    return [torch.device("cpu")] * (device_count or 1)


def cuda_places(device_ids=None):
    if not torch.cuda.is_available():
        return []
    ids = range(torch.cuda.device_count()) if device_ids is None \
        else device_ids
    return [torch.device("cuda", int(i)) for i in ids]


def xpu_places(device_ids=None):
    return []


def data(name: str, shape, dtype="float32", lod_level=0,
         device=None) -> torch.Tensor:
    """A feed placeholder of the current program: a fake tensor of
    ``shape`` (None / -1 recorded as 1) and ``dtype`` on the program's
    device (module docstring)."""
    dims = [1 if s is None or s == -1 else int(s) for s in shape]
    t = fake_like(dims, to_dtype(dtype), _default_device(device))
    prog = default_main_program()
    prog.feeds.append(t)
    prog._names[id(t)] = name
    return t


# ------------------------------------------------------------ replay
def replay(ops, env: Dict[int, torch.Tensor],
           drops: Optional[List[List[int]]] = None
           ) -> Dict[int, torch.Tensor]:
    """Run ``ops`` over ``env`` (variable id -> tensor), adding each op's
    outputs; a concrete input is read as it is now.  ``drops[i]``: the
    ids let go of after op i (``_Plan.drops``)."""
    for i, (fn, ins, outs, _) in enumerate(ops):
        vals = []
        for t in ins:
            v = env.get(id(t))
            if v is None:
                if is_variable(t):
                    raise KeyError(f"static: variable {_label(t)} was not "
                                   "fed or computed")
                v = t
            vals.append(v)
        for o, r in zip(outs, outputs_of(fn(*vals))):
            env[id(o)] = r
        if drops is not None:
            for k in drops[i]:
                env.pop(k, None)
    return env


class _Region:
    """A run of ops recorded inside one ``torch.utils.checkpoint`` call,
    replayed as one op through ``checkpoint``: from ``ins`` (what the ops
    read from outside) to ``outs`` (what is read after them)."""

    def __init__(self, ops, ins, outs):
        self.ops, self.ins, self.outs = ops, ins, outs

    def __call__(self, *vals):
        return checkpoint(self._run, *vals, use_reentrant=False)

    def _run(self, *vals):
        env = replay(self.ops, {id(t): v for t, v in zip(self.ins, vals)})
        return tuple(env[id(o)] for o in self.outs)


def _last_reads(ops) -> Dict[int, int]:
    last: Dict[int, int] = {}
    for i, (_, ins, _, _) in enumerate(ops):
        for t in ins:
            last[id(t)] = i
    return last


def _regions(ops, keep) -> list:
    """``ops`` with each run of ops of one checkpoint region as one
    ``_Region`` op (a run writing in place into what it did not make stays
    flat)."""
    last = _last_reads(ops)
    out, i = [], 0
    while i < len(ops):
        r = getattr(ops[i][0], "region", None)
        j = i + 1
        while (r is not None and j < len(ops)
               and getattr(ops[j][0], "region", None) is r):
            j += 1
        group = ops[i:j]
        made = {id(o) for _, _, outs, _ in group for o in outs}
        ins, seen = [], set()
        for _, g_ins, _, _ in group:
            for t in g_ins:
                if id(t) not in made and id(t) not in seen:
                    seen.add(id(t))
                    ins.append(t)
        inplace = any(id(g_ins[k]) not in made
                      for fn, g_ins, _, _ in group
                      for k in getattr(fn, "mutated", ()))
        if r is None or inplace:
            out.extend(group)
        else:
            outs = [o for _, _, g_outs, _ in group for o in g_outs
                    if id(o) in keep or last.get(id(o), -1) >= j]
            out.append((_Region(group, ins, outs), ins, outs,
                        f"checkpoint[{len(group)} ops]"))
        i = j
    return out
def _label(t) -> str:
    name = default_main_program().name_of(t)
    return repr(name) if name else f"{tuple(t.shape)} {t.dtype}"


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Plan:
    """What a run of one key reads: the concrete tensors, the placeholders
    it needs, whether an op reads the host; built for one op list.  With
    ``keep`` (the ids a run reads after the replay: fetches, the loss)
    each value is let go of after its last reader (``drops``); with
    ``train`` the checkpoint regions replay through ``checkpoint``."""

    def __init__(self, program: Program, keep=None, train=False):
        self.source = program.ops
        self.ops = list(program.ops)
        if train:
            self.ops = _regions(self.ops, keep or set())
        self.drops = None
        if keep is not None:
            last = _last_reads(self.ops)
            self.drops = [[] for _ in self.ops]
            for i, (_, _, outs, _) in enumerate(self.ops):
                for o in outs:
                    last.setdefault(id(o), i)
            for k, i in last.items():
                if k not in keep:
                    self.drops[i].append(k)
        produced = {id(o) for _, _, outs, _ in self.ops for o in outs}
        feeds = {id(t) for t in program.feeds}
        self.consts, self.needed, seen = [], [], set()
        for _, ins, _, _ in self.ops:
            for t in ins:
                if id(t) in produced or id(t) in seen:
                    continue
                seen.add(id(t))
                if id(t) in program._values:
                    continue
                if id(t) in feeds:
                    self.needed.append(t)
                elif is_variable(t):
                    raise KeyError(
                        f"static: variable {_label(t)} is read by the "
                        "program but is not one of its placeholders or "
                        "results (a variable of another program?)")
                else:
                    self.consts.append(t)
        self.host = any(getattr(fn, "host", False)
                        for fn, _, _, _ in self.ops)

    def fresh(self, program: Program) -> bool:
        """Whether the program's op list is still the one planned (a
        pass assigns a new list)."""
        return (self.source is program.ops
                and len(self.ops) == len(program.ops))


def _feed_tensor(value, var: torch.Tensor) -> torch.Tensor:
    """A fed value as a tensor on its placeholder's device (numpy arrays,
    lists and tensors; the fed dtype kept, as the reference keeps it)."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    return value.to(var.device)


def _fetch(env: Dict[int, torch.Tensor], t) -> torch.Tensor:
    v = env.get(id(t))
    if v is not None:
        return v
    if is_variable(t):
        raise KeyError(f"static: fetch {_label(t)} is not computed by the "
                       "program")
    return t


class Executor:
    """Replays a Program (module docstring; the reference's
    ``static.Executor``).  ``place`` is kept for the API: the program's
    tensors carry their device.  ``_graphs`` (None: on for CUDA programs)
    and ``_graph_cache`` let the tests drive the graph path on the CPU
    with a stand-in capture."""

    def __init__(self, place=None):
        self.place = place
        self._cache: Dict[tuple, _Plan] = {}
        self._graphs: Optional[bool] = None
        self._graph_cache = None

    def _plan(self, key, program: Program, keep, train) -> _Plan:
        plan = self._cache.get(key)
        if plan is None or not plan.fresh(program):
            # a pass rewrote the op list: the key's entry is built again
            plan = self._cache[key] = _Plan(program, keep, train)
            if self._graph_cache is not None:
                self._graph_cache.drop(key)
        return plan

    def run(self, program: Optional[Program] = None,
            feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None,
            return_numpy: bool = True):
        with _paused():
            return self._run(program, feed, fetch_list, return_numpy)

    def _run(self, program, feed, fetch_list, return_numpy):
        program = program or default_main_program()
        if isinstance(program, CompiledProgram):
            program = program.program
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        if program is _default_startup or not program.ops:
            return []  # startup collapses: parameters are made eagerly

        known = set(program.feed_names)
        unknown = set(feed) - known
        if unknown:
            raise KeyError(
                f"feed names {sorted(unknown)} match no placeholder in this "
                f"program (placeholders: {sorted(known)})")
        names = program._names
        feed_ts = [t for t in program.feeds if names[id(t)] in feed]
        feed_vals = [_feed_tensor(feed[names[id(t)]], t) for t in feed_ts]
        train = program._loss is not None and program._optimizer is not None
        key = ((program.id, "train") if train else (program.id,)) + (
            len(program.ops), tuple(names[id(t)] for t in feed_ts),
            tuple(tuple(v.shape) for v in feed_vals),
            tuple(id(t) for t in fetch_list))
        keep = {id(t) for t in fetch_list}
        if train:
            keep.add(id(program._loss))
        plan = self._plan(key, program, keep, train)
        fed = {id(t) for t in feed_ts}
        missing = [names[id(t)] for t in plan.needed if id(t) not in fed]
        if missing:
            raise KeyError(f"placeholders {missing} are read by the program "
                           "but not fed")

        def env_of(vals):
            env = {i: v for i, (_, v) in program._values.items()}
            env.update({id(t): v for t, v in zip(feed_ts, vals)})
            return replay(plan.ops, env, plan.drops)

        if train:
            outs = self._run_train(program, plan, env_of, feed_vals,
                                   fetch_list)
        else:
            with torch.no_grad():
                outs = self._run_infer(
                    key, plan, feed_vals,
                    lambda *vals: [_fetch(env_of(vals), t)
                                   for t in fetch_list])
        if return_numpy:
            return [_numpy(o) for o in outs]
        return [o.detach() for o in outs]

    def _graph_path(self, plan: _Plan, feed_vals) -> bool:
        """Whether a no-grad run goes through a CUDA graph: a CUDA program
        (``_graphs`` None) or ``_graphs`` True, and no op reads the
        host."""
        dev = next((v.device for v in feed_vals),
                   next((t.device for t in plan.consts),
                        torch.device("cpu")))
        on = self._graphs if self._graphs is not None else \
            dev.type == "cuda"
        if not on or plan.host:
            return False
        if self._graph_cache is None:
            from ..jit.graphs import GraphCache
            from ..ops.hopper import launch_counters

            self._graph_cache = GraphCache(
                dev, counters=launch_counters, weights=self._weights)
        return True

    def _weights(self) -> List[torch.Tensor]:
        return [t for plan in self._cache.values() for t in plan.consts]

    def _run_infer(self, key, plan: _Plan, feed_vals, run):
        if not self._graph_path(plan, feed_vals):
            return run(*feed_vals)
        cache = self._graph_cache
        cache.watch()
        fresh = key not in cache.graphs
        outs = cache.run(key, run, feed_vals)
        # a replay hands back the graph's own buffers, rewritten by the
        # next replay
        return outs if fresh else [o.clone() for o in outs]

    @staticmethod
    def _run_train(program: Program, plan: _Plan, env_of, feed_vals,
                   fetch_list):
        """One training step: the replay under autograd, the loss's
        gradients on the parameters, then the optimizer's own ``step()``
        and ``clear_grad()`` (the reference's ``_run_train``)."""
        params = [t for t in plan.consts
                  if isinstance(t, torch.nn.Parameter) and t.requires_grad]
        for p in params:
            p.grad = None
        with torch.enable_grad():
            env = env_of(feed_vals)
            _fetch(env, program._loss).backward()
        outs = [_fetch(env, t).detach() for t in fetch_list]
        program._optimizer.step()
        program._optimizer.clear_grad()
        return outs


# -------------------------------------------------------------- scopes
class _Scope:
    def __init__(self):
        self.vars = {}

    def var(self, name):
        return self.vars.setdefault(name, None)

    def find_var(self, name):
        return self.vars.get(name)


_global_scope = _Scope()


def global_scope():
    return _global_scope


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        return self.scope

    def __exit__(self, *exc):
        return False


class name_scope:
    def __init__(self, prefix=None):
        self.prefix = prefix

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------- inference model save/load
class _ProgramLayer(torch.nn.Module):
    """A program's replay from its feeds to its fetches as a layer: its
    parameters registered as ``param_<i>``, its other concrete tensors as
    buffers ``const_<i>`` (what ``jit.save`` writes and exports)."""

    def __init__(self, program: Program, feed_vars, fetch_vars):
        super().__init__()
        self._program = program
        self._feeds = list(feed_vars)
        self._fetches = list(fetch_vars)
        plan = _Plan(program, keep={id(t) for t in self._fetches})
        self._ops, self._drops = plan.ops, plan.drops
        for i, t in enumerate(program.all_parameters()):
            self.register_parameter(f"param_{i}", t)
        params = {id(t) for t in program.all_parameters()}
        for i, t in enumerate(t for t in plan.consts if id(t) not in params):
            self.register_buffer(f"const_{i}", t, persistent=False)

    def forward(self, *feeds):
        env = {i: v for i, (_, v) in self._program._values.items()}
        env.update({id(t): v for t, v in zip(self._feeds, feeds)})
        replay(self._ops, env, self._drops)
        outs = [_fetch(env, t) for t in self._fetches]
        return outs[0] if len(outs) == 1 else tuple(outs)


def save_inference_model(path_prefix: str, feed_vars, fetch_vars,
                         executor=None, program=None, **kwargs):
    """Write the program's replay from ``feed_vars`` to ``fetch_vars`` as a
    ``jit.save`` artifact (parameters, meta and the exported ``.pt2``
    program at the feeds' shapes); a failed export raises."""
    from ..jit import serialization

    program = program or default_main_program()
    feed_vars = (list(feed_vars) if isinstance(feed_vars, (list, tuple))
                 else [feed_vars])
    fetch_vars = (list(fetch_vars) if isinstance(fetch_vars, (list, tuple))
                  else [fetch_vars])
    layer = _ProgramLayer(program, feed_vars, fetch_vars)
    spec = [InputSpec(list(t.shape), str(t.dtype).replace("torch.", ""))
            for t in feed_vars]
    with _paused():
        serialization.save(layer, path_prefix, input_spec=spec)
    with open(path_prefix + ".pdmodel.json") as f:
        err = json.load(f).get("export_error")
    if err is not None:
        raise RuntimeError(f"save_inference_model({path_prefix!r}): the "
                           f"program did not export: {err}")


def load_inference_model(path_prefix: str, executor=None, **kwargs):
    """-> [the loaded program (``jit.load``: call it on the feeds), [],
    []], the reference's return value."""
    from ..jit.serialization import load as jit_load

    return [jit_load(path_prefix), [], []]


# ------------------------------------------------ legacy static surface
class BuildStrategy:
    """Knob bag, kept for the API (fusion and memory are the kernels' and
    the caching allocator's)."""

    def __init__(self):
        self.enable_inplace = True
        self.memory_optimize = True
        self.fuse_elewise_add_act_ops = True
        self.build_cinn_pass = False


class CompiledProgram:
    def __init__(self, program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()

    def __getattr__(self, name):
        return getattr(self.program, name)


def _no_ipu(*a, **k):
    raise NotImplementedError("IPU backend is not part of the CUDA build")


class IpuStrategy:
    def __init__(self, *a, **k):
        _no_ipu()


IpuCompiledProgram = _no_ipu
set_ipu_shard = _no_ipu


class ipu_shard_guard:
    def __init__(self, *a, **k):
        _no_ipu()


class ExponentialMovingAverage:
    """EMA of parameters (float32 shadows) with ``apply`` / ``restore``
    guards that swap the values in place."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self.decay = decay
        self._ema: Dict[int, torch.Tensor] = {}
        self._backup: Dict[int, torch.Tensor] = {}
        self._params: List[torch.Tensor] = []

    def update(self, parameters=None):
        if parameters is not None:
            self._params = list(parameters)
        with torch.no_grad():
            for p in self._params:
                cur = p.detach().float().clone()
                prev = self._ema.get(id(p))
                self._ema[id(p)] = cur if prev is None else \
                    self.decay * prev + (1 - self.decay) * cur

    def apply(self, executor=None, need_restore=True):
        @contextlib.contextmanager
        def guard():
            with torch.no_grad():
                for p in self._params:
                    self._backup[id(p)] = p.detach().clone()
                    if id(p) in self._ema:
                        p.copy_(self._ema[id(p)].to(p.dtype))
            try:
                yield
            finally:
                if need_restore:
                    self.restore()

        return guard()

    def restore(self, executor=None):
        with torch.no_grad():
            for p in self._params:
                if id(p) in self._backup:
                    p.copy_(self._backup.pop(id(p)))


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    dev = torch.device("cpu") if force_cpu else _default_device()
    t = torch.full(list(shape), value, dtype=to_dtype(dtype), device=dev)
    t.persistable = persistable
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None, device=None):
    """A parameter made eagerly on the program's device: zeros for a bias,
    else Xavier-normal (the reference's defaults) drawn from torch's
    default generator.  An initializer (given or in ``attr``) waits for
    ``nn.initializer`` (ROADMAP A10a)."""
    if default_initializer is not None or getattr(attr, "initializer",
                                                  None) is not None:
        raise NotImplementedError(
            "create_parameter with an initializer: nn.initializer is not "
            "ported yet (ROADMAP A10a)")
    t = torch.zeros(list(shape), dtype=to_dtype(dtype),
                    device=_default_device(device))
    if not is_bias:
        fan_in = shape[0] if len(shape) > 1 else 1
        fan_out = shape[1] if len(shape) > 1 else shape[0]
        if len(shape) > 2:
            rf = int(np.prod(shape[2:]))
            fan_in, fan_out = shape[1] * rf, shape[0] * rf
        std = float(np.sqrt(2.0 / (fan_in + fan_out)))
        with torch.no_grad():
            t.normal_(0.0, std)
    return torch.nn.Parameter(t)


def gradients(targets, inputs, target_gradients=None, no_grad_set=None,
              name=None):
    """The gradients of ``targets`` with respect to ``inputs``
    (``torch.autograd.grad``; None for an input they do not reach)."""
    outs = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(target_gradients,
                                                       (list, tuple)):
        target_gradients = [target_gradients]
    return list(torch.autograd.grad(list(outs), list(ins),
                                    grad_outputs=target_gradients,
                                    retain_graph=True, allow_unused=True))


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Marks the program's loss, as ``minimize`` does; returns (parameter,
    None) pairs."""
    prog = default_main_program()
    prog._loss = loss
    params = parameter_list or prog.all_parameters()
    return [(p, None) for p in params]


def accuracy(input, label, k=1, correct=None, total=None,  # noqa: A002
             name=None):
    from ..metric import accuracy as _acc

    return _acc(input, label, k=k)


def _print_value(x, message):
    print((message or "") + str(x))
    return x


def Print(input, first_n=-1, message=None, summarize=20,  # noqa: A002
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=False, print_phase="both"):
    """The identity, printing the value: now, or in a program at each
    replay (an op that reads the host)."""
    if not is_variable(input):
        return _print_value(input, message)

    def op(x):
        return _print_value(x, message)

    out = fake_like(input.shape, input.dtype, input.device)
    record(op, [input], [out], "Print", host=True)
    return out


# ------------------------------------------------ program state save/load
def _named_parameters(program) -> Dict[str, torch.Tensor]:
    """The program's parameters by position: ``param_<i>``, the
    reference's name for a parameter without one."""
    return {f"param_{i}": p
            for i, p in enumerate(program.all_parameters())}


def _arrays(program) -> Dict[str, np.ndarray]:
    return {k: _numpy(p) for k, p in _named_parameters(program).items()}


def _assign(program, arrays) -> None:
    by_name = _named_parameters(program)
    with torch.no_grad():
        for name, arr in arrays.items():
            if name in by_name:
                p = by_name[name]
                p.copy_(torch.as_tensor(np.asarray(arr)).to(p.dtype))


def save(program, model_path, protocol=4, **configs):
    """Every parameter the program reads, by name (``param_<i>``), as
    ``<model_path>.pdparams.npz``."""
    np.savez(model_path + ".pdparams.npz", **_arrays(program))


def load(program, model_path, executor=None, var_list=None):
    _assign(program, dict(np.load(model_path + ".pdparams.npz")))


def load_program_state(model_path, var_list=None):
    return dict(np.load(model_path + ".pdparams.npz"))


def set_program_state(program, state_dict):
    _assign(program, state_dict)


def serialize_program(feed_vars, fetch_vars, **kwargs):
    prog = kwargs.get("program") or default_main_program()
    return json.dumps({"ops": [name for _, _, _, name in prog.ops]}).encode()


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs):
    bio = io.BytesIO()
    np.savez(bio, **_arrays(kwargs.get("program")
                            or default_main_program()))
    return bio.getvalue()


def deserialize_persistables(program, data, executor=None):
    _assign(program, dict(np.load(io.BytesIO(data))))
