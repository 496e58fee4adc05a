"""Passes over a recorded Program — the port of
``paddle_tpu/static/passes.py``: the IR dump, dead code elimination,
common subexpression elimination and constant folding, each rewriting the
op list and reporting how many ops it changed (``PassManager.stats``).

A recorded op is (fn, inputs, outputs, name) with fn a callable of the
input tensors (``static._Call`` for an aten or kernel op).  The reference
keys CSE by the identity of an op's pure fn; here every recorded call is
its own object, so an aten or kernel op is keyed by its value
(``_Call.cse_key``: the op and its non-tensor arguments), other ops (the
control flow's, ``py_func``) by identity, and the inputs by identity and
by how many in-place writes their memory has taken.  A random op, one
that writes in place and one whose output's memory is written in place
later never merges.  A replay after each pass gives the same
fetches.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch.nn import Parameter

__all__ = ["PassBase", "PassManager", "DeadCodeEliminationPass",
           "CommonSubexpressionEliminationPass", "ConstantFoldingPass",
           "print_program", "program_to_str"]


def _static():
    from .. import static

    return static


# ------------------------------------------------------------- inspection
def program_to_str(program) -> str:
    """Readable dump of a recorded Program: one line per op, its outputs
    and inputs named %feed<i>, %param<i> or %v<i> with their shapes."""
    names: Dict[int, str] = {}
    feeds = {id(t) for t in program.feeds}

    def name_of(t):
        if id(t) not in names:
            tag = "feed" if id(t) in feeds else (
                "param" if isinstance(t, Parameter) else "v")
            names[id(t)] = f"%{tag}{len(names)}"
        return names[id(t)]

    def shape(t):
        return "x".join(str(s) for s in t.shape)

    lines = [f"program(id={program.id}, ops={len(program.ops)}, "
             f"feeds={program.feed_names})"]
    for _, ins, outs, op_name in program.ops:
        in_s = ", ".join(f"{name_of(t)}:{shape(t)}" for t in ins)
        out_s = ", ".join(f"{name_of(t)}:{shape(t)}" for t in outs)
        lines.append(f"  {out_s} = {op_name or 'op'}({in_s})")
    return "\n".join(lines)


def print_program(program) -> None:
    print(program_to_str(program))


# ------------------------------------------------------------------ passes
class PassBase:
    """One rewrite over a Program's op list."""

    name = "pass"

    def run(self, program) -> int:
        """Apply; returns the number of ops changed or removed."""
        raise NotImplementedError


class DeadCodeEliminationPass(PassBase):
    """Drop ops whose outputs nothing reads.  ``keep`` marks fetch targets;
    the program's loss is always live."""

    name = "dead_code_elimination"

    def __init__(self, keep: Sequence = ()):
        self.keep = list(keep)

    def run(self, program) -> int:
        live = {id(t) for t in self.keep}
        if program._loss is not None:
            live.add(id(program._loss))
        kept: List = list(program.ops)
        changed = True
        while changed:
            # inputs of removed ops may free further ops next round
            used = set(live)
            for _, ins, _, _ in kept:
                used.update(id(t) for t in ins)
            nxt = [op for op in kept if any(id(o) in used for o in op[2])]
            changed = len(nxt) != len(kept)
            kept = nxt
        removed = len(program.ops) - len(kept)
        program.ops = kept
        return removed


def _alias(*vs):
    return vs[0] if len(vs) == 1 else vs


def _storage(t) -> int:
    """The identity of ``t``'s memory (a view shares its base's)."""
    return t.untyped_storage()._cdata


class CommonSubexpressionEliminationPass(PassBase):
    """Merge ops that compute the same value from the same inputs (module
    docstring).  A merged op's outputs stay fetchable through a
    ``<name>_cse_alias`` op of the first op's outputs (a fetch list is a
    use the pass cannot see)."""

    name = "common_subexpression_elimination"

    def run(self, program) -> int:
        seen: Dict = {}
        replace: Dict[int, object] = {}
        writes: Dict[int, int] = {}
        # memory written in place anywhere: an op making it (empty_like
        # before a bernoulli_, a value later updated) never merges
        written = {_storage(ins[k]) for fn, ins, _, _ in program.ops
                   for k in getattr(fn, "mutated", ())}
        kept = []
        merged = 0
        for fn, ins, outs, op_name in program.ops:
            ins = [replace.get(id(t), t) for t in ins]
            key_fn = getattr(fn, "cse_key", None)
            fkey = key_fn() if key_fn is not None else id(fn)
            if any(_storage(o) in written for o in outs):
                fkey = None
            key = None if fkey is None else (
                fkey, tuple((id(t), writes.get(_storage(t), 0))
                            for t in ins), op_name)
            prev = seen.get(key) if key is not None else None
            if prev is not None and len(prev) == len(outs):
                for old, new in zip(outs, prev):
                    replace[id(old)] = new
                kept.append((_alias, list(prev), outs,
                             f"{op_name}_cse_alias"))
                merged += 1
                continue
            for k in getattr(fn, "mutated", ()):
                w = _storage(ins[k])
                writes[w] = writes.get(w, 0) + 1
            if key is not None:
                seen[key] = outs
            kept.append((fn, ins, outs, op_name))
        program.ops = kept
        if replace and program._loss is not None:
            program._loss = replace.get(id(program._loss), program._loss)
        return merged


class ConstantFoldingPass(PassBase):
    """Run the ops whose inputs are all constants (concrete tensors that
    are neither parameters nor made by an op left in the program, or
    variables bound by ``Program.bind`` or folded before) once, now: their
    outputs become bound values of the program instead of ops of every
    run.  An op reading a parameter stays: a run reads the parameter as it
    is then."""

    name = "constant_folding"

    def run(self, program) -> int:
        st = _static()
        folded = 0
        kept = []
        made = set()

        def value(t):
            v = program.value_of(t)
            return t if v is None else v

        def constant(t):
            if program.value_of(t) is not None:
                return True
            return not (st.is_variable(t) or isinstance(t, Parameter)
                        or id(t) in made)

        for fn, ins, outs, op_name in program.ops:
            if all(constant(t) for t in ins):
                with torch.no_grad():
                    res = fn(*[value(t) for t in ins])
                for o, r in zip(outs, st.outputs_of(res)):
                    program._values[id(o)] = (o, r)
                folded += 1
                continue
            made.update(id(o) for o in outs)
            kept.append((fn, ins, outs, op_name))
        program.ops = kept
        return folded


class PassManager:
    """Ordered pass pipeline with statistics."""

    def __init__(self, passes: Optional[Sequence[PassBase]] = None,
                 print_stats: bool = False):
        self.passes: List[PassBase] = list(passes or [])
        self.print_stats = print_stats
        self.stats: List[tuple] = []

    def add_pass(self, p: PassBase) -> "PassManager":
        self.passes.append(p)
        return self

    def run(self, program) -> Dict[str, int]:
        self.stats = []
        for p in self.passes:
            n = p.run(program)
            self.stats.append((p.name, n))
            if self.print_stats:
                print(f"[pass] {p.name}: {n} ops affected")
        return dict(self.stats)
