"""The port's ``static`` core (``paddle_tpu_torch/static``) against the JAX
package's, on the CPU: ``tests/test_static.py``'s cases on both packages
with the same numpy feeds and weights (``state_dict()`` -> numpy ->
``load_numpy_state_dict`` or a copy), each port program built under
``static.device_guard("cpu")``.

- Capture and fetch, the multi-op graph, a ``Linear``, the Executor's cache
  (and its graph path with a stand-in capture), the default programs and
  guard nesting, ``all_parameters``, ``clone``, the two feed
  ``KeyError``s, the IR dump and the passes (fetches after DCE, CSE and
  constant folding equal the reference's): float32, rtol 1e-6 (the same
  elementwise ops; the Linear's product sums 4 terms).
- ``llama_tiny``'s static forward logits against the reference's static
  Executor within 1e-5 of the largest |logit| (the suite's float32
  rule: XLA and PyTorch sum the projections in other orders; measured
  2.9e-6), and equal bit for bit to the port's eager forward.
- Three ``AdamW.minimize`` steps of its ``pretraining_loss`` against the
  reference's losses step by step, rtol 1e-5 (measured 4e-7), and bit for
  bit against an eager twin of the same weights; the same recorded under
  ``auto_cast`` O1 (no cast recorded, the reference's losses), and with
  ``config.recompute`` (the checkpointed regions replayed through
  ``checkpoint``: the twin's plain-version calls and losses bit for bit);
  a weight-derived op recomputed at each replay (after an in-place weight
  load on the graph path, and under SGD, bit for bit against eager); the
  minimize loop of
  ``test_minimize_loop_reduces_loss`` (SGD, 30 steps) against the
  reference's losses step by step, rtol 1e-5, not against that test's
  gate.
- ``save_inference_model`` / ``load_inference_model``, host reads of a
  placeholder, and the kernel ops' autograd registration: an eager
  forward and backward of ``llama_tiny`` calls each plain version and
  counts each launch as before it, and an eager step imports no
  ``torch._dynamo``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as pt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny as jax_llama_tiny
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import static
from paddle_tpu_torch.jit.graphs import GraphCache
from paddle_tpu_torch.models import llama as pllama
from paddle_tpu_torch.ops.hopper import launch_counters
from paddle_tpu_torch.optimizer import SGD, AdamW

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _static_mode():
    P.enable_static()
    pt.enable_static()
    with static.device_guard("cpu"):
        yield
    pt.disable_static()
    P.disable_static()


def _progs():
    return P.static.Program(), static.Program()


def _run(prog_pair, feed, fetch_pair):
    """Each package's Executor over the same feed -> (ref, ours)."""
    ref = P.static.Executor().run(prog_pair[0], feed=feed,
                                  fetch_list=fetch_pair[0])
    ours = static.Executor().run(prog_pair[1], feed=feed,
                                 fetch_list=fetch_pair[1])
    return ref, ours


def _close(ref, ours, rtol=1e-6):
    assert len(ref) == len(ours)
    for r, o in zip(ref, ours):
        np.testing.assert_allclose(o, np.asarray(r), rtol=rtol, atol=1e-7)


def _linear_pair(n_in, n_out):
    jl = P.nn.Linear(n_in, n_out)
    pl = pnn.Linear(n_in, n_out, device="cpu", generator=torch.Generator())
    pnn.load_numpy_state_dict(pl, {k: np.asarray(v._value)
                                   for k, v in jl.state_dict().items()})
    return jl, pl


# ---------------------------------------------------------------- capture
def test_ops_are_recorded_and_fetchable():
    jm, pm = _progs()
    with P.static.program_guard(jm, P.static.Program()):
        jx = P.static.data("x", [2, 3], "float32")
        jy = jx * 2.0 + 1.0
    with static.program_guard(pm, static.Program()):
        x = static.data("x", [2, 3], "float32")
        y = x * 2.0 + 1.0
        assert len(pm.ops) >= 1          # recorded, not run
        assert static.is_variable(y) and y.device.type == "cpu"
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    _close(*_run((jm, pm), feed, ([jy], [y])))


def test_multi_op_graph():
    jm, pm = _progs()
    with P.static.program_guard(jm):
        jx = P.static.data("x", [4], "float32")
        jz = P.sum(P.exp(jx) * jx)
    with static.program_guard(pm):
        x = static.data("x", [4], "float32")
        z = (torch.exp(x) * x).sum()
    feed = {"x": np.array([0.1, 0.2, 0.3, 0.4], np.float32)}
    _close(*_run((jm, pm), feed, ([jz], [z])))


def test_layer_under_static():
    jm, pm = _progs()
    with P.static.program_guard(jm):
        jx = P.static.data("x", [2, 4], "float32")
        jl, pl = _linear_pair(4, 3)
        jo = jl(jx)
    with static.program_guard(pm):
        x = static.data("x", [2, 4], "float32")
        o = pl(x)
    feed = {"x": np.random.default_rng(0).standard_normal((2, 4)).astype(
        np.float32)}
    _close(*_run((jm, pm), feed, ([jo], [o])))


def test_executor_caches_its_programs():
    pm = static.Program()
    with static.program_guard(pm):
        x = static.data("x", [3], "float32")
        y = x * 3.0
    exe = static.Executor()
    exe.run(pm, feed={"x": np.ones(3, np.float32)}, fetch_list=[y])
    n = len(exe._cache)
    (out,) = exe.run(pm, feed={"x": np.zeros(3, np.float32)}, fetch_list=[y])
    assert len(exe._cache) == n == 1 and float(np.abs(out).max()) == 0.0


class _Replayed:
    """A CUDA graph's stand-in: a replay runs the captured function again
    into the outputs the capture returned."""

    def __init__(self, fn, outputs):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        self.replays += 1
        for o, n in zip(self.outputs, self.fn()):
            o.copy_(n)


def _stub_capture(fn, pool):
    out = fn()
    return _Replayed(fn, out), out


def test_executor_graph_path_replays_its_key():
    """The graph path (on for CUDA programs) driven here with a stand-in
    capture: one capture per key, later runs replay it, a program with a
    host-reading op runs eagerly, and the fetches follow the feeds and
    the parameters' in-place updates."""
    _, pl = _linear_pair(4, 3)
    pm = static.Program()
    with static.program_guard(pm):
        x = static.data("x", [2, 4], "float32")
        o = pl(x)
    exe = static.Executor()
    exe._graphs = True
    exe._graph_cache = GraphCache("cpu", counters=launch_counters,
                                  capture=_stub_capture,
                                  weights=exe._weights)
    rng = np.random.default_rng(1)
    for i in range(3):
        xv = rng.standard_normal((2, 4)).astype(np.float32)
        (got,) = exe.run(pm, feed={"x": xv}, fetch_list=[o])
        with torch.no_grad():
            ref = pl(torch.from_numpy(xv)).numpy()
        np.testing.assert_array_equal(got, ref)
        if i == 1:
            with torch.no_grad():
                pl.weight.mul_(2.0)
    (g,) = exe._graph_cache.graphs.values()
    assert exe._graph_cache.captures == 1 and g.graph.replays == 2
    assert len(exe._cache) == 1
    import paddle_tpu_torch.static.nn as snn

    with static.program_guard(pm):
        flag = static.data("flag", [1], "bool")
        o2 = snn.cond(flag, lambda: o * 2.0, lambda: o)
    exe.run(pm, feed={"x": xv, "flag": np.array([True])}, fetch_list=[o2])
    assert exe._graph_cache.captures == 1


# ------------------------------------------------------------ program API
def test_default_programs_and_guard_nesting():
    a, b = static.Program(), static.Program()
    with static.program_guard(a):
        assert static.default_main_program() is a
        with static.program_guard(b):
            assert static.default_main_program() is b
        assert static.default_main_program() is a
    assert static.default_main_program() is not a
    assert static.Executor().run(static.default_startup_program()) == []


def test_all_parameters_and_clone():
    _, pl = _linear_pair(4, 3)
    pm = static.Program()
    with static.program_guard(pm):
        x = static.data("x", [2, 4], "float32")
        pl(x) * 1.0
    assert {id(p) for p in pm.all_parameters()} == {id(pl.weight),
                                                    id(pl.bias)}
    c = pm.clone()
    assert len(c.ops) == len(pm.ops) and c.feed_names == ["x"]


@pytest.mark.parametrize("feed,match", [({"wrong": np.ones(3, np.float32)},
                                         "wrong"), ({}, "x")])
def test_feed_errors(feed, match):
    for pkg, prog in ((P.static, P.static.Program()),
                      (static, static.Program())):
        with pkg.program_guard(prog):
            x = pkg.data("x", [3], "float32")
            y = x * 2.0
        with pytest.raises(KeyError, match=match):
            pkg.Executor().run(prog, feed=feed, fetch_list=[y])


@pytest.mark.parametrize("read", ["item", "bool", "numpy", "tolist", "float"])
def test_a_placeholder_read_raises(read):
    with static.program_guard(static.Program()):
        x = static.data("x", [1], "float32")
        y = x + 1.0
        with pytest.raises(RuntimeError, match="reads a program variable"):
            getattr(y, read)() if read not in ("bool", "float") else \
                {"bool": bool, "float": float}[read](y)


# ----------------------------------------------------------------- passes
def test_ir_dump():
    pm = static.Program()
    with static.program_guard(pm):
        x = static.data("x", [4], "float32")
        torch.exp(x) * 2.0
    text = str(pm)
    assert "program(id=" in text and "exp" in text and "%feed" in text


def test_dead_code_elimination():
    jm, pm = _progs()
    with P.static.program_guard(jm):
        jx = P.static.data("x", [4], "float32")
        jy = jx * 2.0
        _ = P.exp(jx) + 1.0
    with static.program_guard(pm):
        x = static.data("x", [4], "float32")
        y = x * 2.0
        _ = torch.exp(x) + 1.0
    n_before = len(pm.ops)
    for pkg, prog, keep in ((P.static, jm, jy), (static, pm, y)):
        stats = pkg.PassManager([pkg.DeadCodeEliminationPass(keep=[keep])]
                                ).run(prog)
        assert stats["dead_code_elimination"] >= 2
    assert len(pm.ops) < n_before
    _close(*_run((jm, pm), {"x": np.ones(4, np.float32)}, ([jy], [y])))


def test_constant_folding_freezes_a_bound_feed():
    import jax.numpy as jnp

    jm, pm = _progs()
    with P.static.program_guard(jm):
        jx = P.static.data("x", [3], "float32")
        jy = P.exp(jx) * 2.0
    with static.program_guard(pm):
        x = static.data("x", [3], "float32")
        y = torch.exp(x) * 2.0
    jx._value = jnp.ones(3, jnp.float32)
    pm.bind(x, np.ones(3, np.float32))
    for pkg, prog in ((P.static, jm), (static, pm)):
        stats = pkg.PassManager([pkg.ConstantFoldingPass()]).run(prog)
        assert stats["constant_folding"] >= 2 and len(prog.ops) == 0
    np.testing.assert_allclose(pm.value_of(y).numpy(),
                               np.asarray(jy._value), rtol=1e-6)


def test_cse_merges_a_repeated_op():
    from paddle_tpu.ops.dispatch import apply as _apply

    def double(v):  # one fn object applied twice
        return v * 2

    jm, pm = _progs()
    with P.static.program_guard(jm):
        jx = P.static.data("x", [2], "float32")
        jy = (_apply(double, jx, op_name="double")
              + _apply(double, jx, op_name="double"))
    with static.program_guard(pm):
        x = static.data("x", [2], "float32")
        y = x * 2.0 + x * 2.0
    for pkg, prog in ((P.static, jm), (static, pm)):
        stats = pkg.PassManager([pkg.CommonSubexpressionEliminationPass()]
                                ).run(prog)
        assert stats["common_subexpression_elimination"] == 1
    _close(*_run((jm, pm), {"x": np.ones(2, np.float32)}, ([jy], [y])))


def test_cse_keeps_random_and_in_place_ops_apart():
    pm = static.Program()
    with static.program_guard(pm):
        x = static.data("x", [64], "float32")
        a = torch.nn.functional.dropout(x, 0.5)
        b = torch.nn.functional.dropout(x, 0.5)
        h = x * 1.0
        c = h * 2.0
        h.add_(1.0)
        d = h * 2.0
    stats = static.PassManager([static.CommonSubexpressionEliminationPass()]
                               ).run(pm)
    assert stats["common_subexpression_elimination"] == 0
    out = static.Executor().run(pm, feed={"x": np.ones(64, np.float32)},
                                fetch_list=[a, b, c, d])
    assert not np.array_equal(out[0], out[1])
    np.testing.assert_array_equal(out[2], 2.0)
    np.testing.assert_array_equal(out[3], 4.0)


def test_fetching_cse_merged_and_folded_outputs():
    import jax.numpy as jnp
    from paddle_tpu.ops.dispatch import apply as _apply

    def triple(v):
        return v * 3

    jm, pm = _progs()
    with P.static.program_guard(jm):
        jx = P.static.data("x", [2], "float32")
        _apply(triple, jx, op_name="triple")
        jb = _apply(triple, jx, op_name="triple")
        jc = P.exp(P.static.data("x2", [2], "float32"))
    with static.program_guard(pm):
        x = static.data("x", [2], "float32")
        x * 3.0
        b = x * 3.0
        c = torch.exp(static.data("x2", [2], "float32"))
    for pkg, prog in ((P.static, jm), (static, pm)):
        pkg.PassManager([pkg.CommonSubexpressionEliminationPass()]).run(prog)
    feed = {"x": np.ones(2, np.float32), "x2": np.zeros(2, np.float32)}
    _close(*_run((jm, pm), feed, ([jb], [b])))
    jm.feeds[1]._value = jnp.ones(2, jnp.float32)
    pm.bind(pm.feeds[1], np.ones(2, np.float32))
    for pkg, prog in ((P.static, jm), (static, pm)):
        pkg.PassManager([pkg.ConstantFoldingPass()]).run(prog)
    _close(*_run((jm, pm), {"x": np.ones(2, np.float32)}, ([jc], [c])))


# ------------------------------------------------------------- Llama tiny
def _llama_pair():
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    P.seed(0)
    jm = JaxLlama(jax_llama_tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    cfg = pllama.LlamaConfig(**dataclasses.asdict(jm.config))
    pm = pllama.load_numpy_state_dict(
        pllama.LlamaForCausalLM(cfg, device="cpu"), sd)
    return jm, pm, sd


def _ids(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (2, 16)).astype(np.int32),
            rng.integers(0, 512, (2, 16)).astype(np.int32))


def test_llama_static_forward_matches_the_reference_and_eager():
    jm, pm, _ = _llama_pair()
    jp, pp = _progs()
    with P.static.program_guard(jp):
        jl = jm(P.static.data("ids", [2, 16], "int32"))
    with static.program_guard(pp), torch.no_grad():
        ids_v = static.data("ids", [2, 16], "int32")
        logits = pm(ids_v)
    assert any("paddle_tpu_torch.rms_norm" in n for *_, n in pp.ops)
    assert any("paddle_tpu_torch.flash_attention" in n for *_, n in pp.ops)
    ids, _ = _ids()
    (ref,), (ours,) = _run((jp, pp), {"ids": ids}, ([jl], [logits]))
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    pt.disable_static()
    with torch.no_grad():
        eager = pm(torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(ours, eager)


def test_llama_adamw_minimize_matches_the_reference_and_eager():
    jm, pm, sd = _llama_pair()
    jp, pp = _progs()
    with P.static.program_guard(jp):
        jids = P.static.data("ids", [2, 16], "int32")
        jlab = P.static.data("labels", [2, 16], "int32")
        jloss = jm.pretraining_loss(jids, jlab)
        P.optimizer.AdamW(learning_rate=1e-3,
                          parameters=jm.parameters()).minimize(jloss)
    with static.program_guard(pp):
        ids_v = static.data("ids", [2, 16], "int32")
        lab_v = static.data("labels", [2, 16], "int32")
        loss = pm.pretraining_loss(ids_v, lab_v)
        AdamW(learning_rate=1e-3, parameters=pm.parameters()).minimize(loss)
    ids, labels = _ids()
    feed = {"ids": ids, "labels": labels}
    jexe, pexe = P.static.Executor(), static.Executor()
    ref = [float(np.asarray(jexe.run(jp, feed=feed, fetch_list=[jloss])[0]))
           for _ in range(3)]
    ours = [float(pexe.run(pp, feed=feed, fetch_list=[loss])[0])
            for _ in range(3)]
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert ours[2] < ours[0]
    pt.disable_static()
    twin = pllama.load_numpy_state_dict(
        pllama.LlamaForCausalLM(pm.config, device="cpu"), sd)
    opt = AdamW(learning_rate=1e-3, parameters=twin.parameters())
    eager = []
    for _ in range(3):
        lv = twin.pretraining_loss(torch.as_tensor(ids),
                                   torch.as_tensor(labels))
        eager.append(float(lv.detach()))
        opt.minimize(lv)
        opt.clear_grad()
    assert ours == eager


def test_llama_adamw_minimize_under_o1_matches_the_reference():
    """Recorded under ``auto_cast`` O1, a float32 program takes no AMP
    cast, as the reference records its ops before their casts: three
    ``AdamW.minimize`` steps give the reference's losses (rtol 1e-5), and
    no bf16 copy of a weight is frozen into the program, so every step
    trains and reads the weights the step before it wrote."""
    from paddle_tpu_torch import amp

    jm, pm, _ = _llama_pair()
    jp, pp = _progs()
    with P.amp.auto_cast(level="O1", dtype="bfloat16"):
        with P.static.program_guard(jp):
            jids = P.static.data("ids", [2, 16], "int32")
            jlab = P.static.data("labels", [2, 16], "int32")
            jloss = jm.pretraining_loss(jids, jlab)
            P.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters()).minimize(jloss)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        with static.program_guard(pp):
            ids_v = static.data("ids", [2, 16], "int32")
            lab_v = static.data("labels", [2, 16], "int32")
            loss = pm.pretraining_loss(ids_v, lab_v)
            AdamW(learning_rate=1e-3,
                  parameters=pm.parameters()).minimize(loss)
    assert not any("_to_copy" in n and any(isinstance(t, torch.nn.Parameter)
                                           for t in ins)
                   for _, ins, _, n in pp.ops)
    ids, labels = _ids()
    feed = {"ids": ids, "labels": labels}
    jexe, pexe = P.static.Executor(), static.Executor()
    ref = [float(np.asarray(jexe.run(jp, feed=feed, fetch_list=[jloss])[0]))
           for _ in range(3)]
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        ours = [float(pexe.run(pp, feed=feed, fetch_list=[loss])[0])
                for _ in range(3)]
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert ours[2] < ours[1] < ours[0]


def test_a_weight_derived_op_reads_the_weights_of_each_run():
    """An op on a parameter alone (here the decode step's q/k/v
    concatenation) is recorded where the program first reads its result,
    so a replay, on the graph path too, computes it from the weights as
    they are: after an in-place weight load the fetched logits are the
    eager forward's over the new weights, bit for bit."""
    _, pm, _ = _llama_pair()
    cfg = pm.config
    other = pllama.LlamaForCausalLM(cfg, device="cpu", seed=5)
    g = torch.Generator().manual_seed(2)
    shape = (2, 3, cfg.num_key_value_heads, cfg.head_dim)
    caches = [(torch.randn(shape, generator=g), torch.randn(shape, generator=g))
              for _ in range(cfg.num_hidden_layers)]
    pp = static.Program()
    with static.program_guard(pp), torch.no_grad():
        ids_v = static.data("ids", [2, 1], "int32")
        logits, _ = pm(ids_v, caches=caches)
    assert any("aten.cat" in n for *_, n in pp.ops)
    params = {id(p) for p in pp.all_parameters()}
    for a in (layer.self_attn for layer in pm.llama.layers):
        assert id(a.q_proj.weight) in params
    exe = static.Executor()
    exe._graphs = True
    exe._graph_cache = GraphCache("cpu", counters=launch_counters,
                                  capture=_stub_capture,
                                  weights=exe._weights)
    ids = np.array([[3], [7]], np.int32)

    def eager():
        pt.disable_static()
        try:
            with torch.no_grad():
                return pm(torch.as_tensor(ids), caches=caches)[0].numpy()
        finally:
            pt.enable_static()

    for _ in range(2):
        (got,) = exe.run(pp, feed={"ids": ids}, fetch_list=[logits])
        np.testing.assert_array_equal(got, eager())
    pllama.load_numpy_state_dict(pm, {k: v.detach().numpy()
                                      for k, v in other.state_dict().items()})
    (got,) = exe.run(pp, feed={"ids": ids}, fetch_list=[logits])
    np.testing.assert_array_equal(got, eager())
    assert exe._graph_cache.captures == 1


def test_training_reaches_a_weight_derived_op():
    """SGD through ``x @ (w * 2)``: the product reads the scaled weight of
    each step (the program holds the scaling), bit for bit as an eager
    twin's steps."""
    _, pl = _linear_pair(4, 1)
    _, twin = _linear_pair(4, 1)
    with torch.no_grad():
        twin.weight.copy_(pl.weight)
        twin.bias.copy_(pl.bias)
    pm = static.Program()
    with static.program_guard(pm):
        x = static.data("x", [8, 4], "float32")
        y = static.data("y", [8, 1], "float32")
        loss = ((x @ (pl.weight * 2.0) + pl.bias - y) ** 2).mean()
        SGD(learning_rate=0.02, parameters=pl.parameters()).minimize(loss)
    assert {id(p) for p in pm.all_parameters()} == {id(pl.weight),
                                                    id(pl.bias)}
    rs = np.random.RandomState(0)
    xv = rs.randn(8, 4).astype(np.float32)
    yv = rs.randn(8, 1).astype(np.float32)
    exe = static.Executor()
    ours = [float(exe.run(pm, feed={"x": xv, "y": yv},
                          fetch_list=[loss])[0]) for _ in range(5)]
    pt.disable_static()
    opt = SGD(learning_rate=0.02, parameters=twin.parameters())
    eager = []
    for _ in range(5):
        lv = ((torch.from_numpy(xv) @ (twin.weight * 2.0) + twin.bias
               - torch.from_numpy(yv)) ** 2).mean()
        eager.append(float(lv.detach()))
        opt.minimize(lv)
        opt.clear_grad()
    assert ours == eager
    assert ours[-1] < ours[0]


def test_a_derived_tensor_written_in_place_stays_what_it_holds():
    """A tensor derived from a parameter and then written in place holds
    what it was given: the program reads it as a constant (its
    derivation would lose the write)."""
    _, pl = _linear_pair(4, 1)
    with torch.no_grad():
        w2 = pl.weight * 2.0
        w2.add_(1.0)
    pm = static.Program()
    with static.program_guard(pm):
        x = static.data("x", [2, 4], "float32")
        y = x @ w2
    xv = np.ones((2, 4), np.float32)
    (got,) = static.Executor().run(pm, feed={"x": xv}, fetch_list=[y])
    np.testing.assert_array_equal(got, (torch.from_numpy(xv) @ w2).numpy())
    assert len(pm.ops) == 1


def test_checkpointed_regions_replay_through_checkpoint(monkeypatch):
    """With ``config.recompute`` each layer, and in every program each
    chunk of ``pretraining_loss``, was recorded inside a
    ``torch.utils.checkpoint`` call: a training run replays each through
    ``checkpoint`` (its forward kernels run again in the backward, as many
    plain-version calls a step as the eager twin's), and the losses of
    three AdamW steps equal the twin's bit for bit and the reference's
    (rtol 1e-5)."""
    from paddle_tpu_torch.static import _Region

    jm, _, sd = _llama_pair()
    cfg = dataclasses.replace(
        pllama.LlamaConfig(**dataclasses.asdict(jm.config)), recompute=True)
    pm = pllama.load_numpy_state_dict(
        pllama.LlamaForCausalLM(cfg, device="cpu"), sd)
    twin = pllama.load_numpy_state_dict(
        pllama.LlamaForCausalLM(cfg, device="cpu"), sd)
    jp, pp = _progs()
    with P.static.program_guard(jp):
        jids = P.static.data("ids", [2, 16], "int32")
        jlab = P.static.data("labels", [2, 16], "int32")
        jloss = jm.pretraining_loss(jids, jlab)
        P.optimizer.AdamW(learning_rate=1e-3,
                          parameters=jm.parameters()).minimize(jloss)
    with static.program_guard(pp):
        ids_v = static.data("ids", [2, 16], "int32")
        lab_v = static.data("labels", [2, 16], "int32")
        loss = pm.pretraining_loss(ids_v, lab_v)
        AdamW(learning_rate=1e-3, parameters=pm.parameters()).minimize(loss)
    ids, labels = _ids()
    feed = {"ids": ids, "labels": labels}
    jexe, pexe = P.static.Executor(), static.Executor()
    ref = [float(np.asarray(jexe.run(jp, feed=feed, fetch_list=[jloss])[0]))
           for _ in range(3)]
    calls = _plain_calls(monkeypatch)
    ours = [float(pexe.run(pp, feed=feed, fetch_list=[loss])[0])]
    static_calls = dict(calls)
    ours += [float(pexe.run(pp, feed=feed, fetch_list=[loss])[0])
             for _ in range(2)]
    (plan,) = pexe._cache.values()
    regions = [fn for fn, *_ in plan.ops if isinstance(fn, _Region)]
    assert len(regions) > cfg.num_hidden_layers
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    pt.disable_static()
    opt = AdamW(learning_rate=1e-3, parameters=twin.parameters())
    eager = []
    for i in range(3):
        calls.clear()
        lv = twin.pretraining_loss(torch.as_tensor(ids),
                                   torch.as_tensor(labels))
        eager.append(float(lv.detach()))
        opt.minimize(lv)
        opt.clear_grad()
        if i == 0:
            assert calls == static_calls
            assert calls["_ref_rms"] == 2 * (2 * cfg.num_hidden_layers) + 1
    assert ours == eager


def test_minimize_loop_matches_the_reference_step_by_step():
    """test_static.py's minimize loop on both packages: the losses step by
    step (the reference's own gate there is red since its seed)."""
    jm, pm = _progs()
    jl, pl = _linear_pair(4, 1)
    with P.static.program_guard(jm):
        jx = P.static.data("x", [8, 4], "float32")
        jy = P.static.data("y", [8, 1], "float32")
        jloss = P.mean((jl(jx) - jy) ** 2)
        P.optimizer.SGD(learning_rate=0.1,
                        parameters=jl.parameters()).minimize(jloss)
    with static.program_guard(pm):
        x = static.data("x", [8, 4], "float32")
        y = static.data("y", [8, 1], "float32")
        loss = ((pl(x) - y) ** 2).mean()
        SGD(learning_rate=0.1, parameters=pl.parameters()).minimize(loss)
    rs = np.random.RandomState(0)
    feed = {"x": rs.randn(8, 4).astype(np.float32),
            "y": rs.randn(8, 1).astype(np.float32)}
    jexe, pexe = P.static.Executor(), static.Executor()
    ref = [float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jloss])[0]))
           for _ in range(30)]
    ours = [float(pexe.run(pm, feed=feed, fetch_list=[loss])[0])
            for _ in range(30)]
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert ours[-1] < ours[0]


def test_eager_minimize_runs_backward_and_step():
    pt.disable_static()
    _, pl = _linear_pair(4, 1)
    w0 = pl.weight.detach().clone()
    loss = (pl(torch.ones(2, 4)) ** 2).mean()
    assert SGD(learning_rate=0.5,
               parameters=pl.parameters()).minimize(loss) == (None, None)
    assert not torch.equal(w0, pl.weight.detach())


def test_save_and_load_inference_model(tmp_path):
    _, pm, _ = _llama_pair()
    pp = static.Program()
    with static.program_guard(pp), torch.no_grad():
        ids_v = static.data("ids", [2, 16], "int32")
        logits = pm(ids_v)
    ids, _ = _ids(3)
    (ref,) = static.Executor().run(pp, feed={"ids": ids},
                                   fetch_list=[logits])
    path = str(tmp_path / "llama")
    static.save_inference_model(path, [ids_v], [logits], program=pp)
    pt.disable_static()
    loaded, feeds, fetches = static.load_inference_model(path)
    assert feeds == [] and fetches == []
    out = loaded(torch.as_tensor(ids))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


# ------------------------------------ kernel ops under autograd, eager
def _plain_calls(monkeypatch):
    """Count each kernel's plain version (forward and backward) as the
    eager Llama calls it on the CPU."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper import fused_norm as fn
    from paddle_tpu_torch.ops.hopper import fused_ops as fo

    calls = {}

    def count(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for mod, name in ((fn, "_ref_rms"), (fn, "_ref_rms_residual"),
                      (fn, "_rms_bwd"), (fn, "_rms_residual_bwd"),
                      (fo, "_rope_ref"), (fo, "rope_bwd_fused"),
                      (fo, "_swiglu_ref"), (fo, "swiglu_bwd_fused"),
                      (fa, "_plain_bshd"), (fa, "flash_attention_bwd_fused")):
        count(mod, name)
    return calls


def test_kernel_autograd_leaves_eager_calls_and_counts(monkeypatch):
    """The five kernel ops' "Autograd" registration (for a static training
    replay) leaves an eager forward and backward as they were: each plain
    version runs once a call of its wrapper (n layers: K1 2n + 1 norms,
    one of them without a residual; K2, K3, B1 n each; their backwards
    once each, the residual norms' through ``_rms_bwd`` too, K2's through
    ``_rope_ref`` with -sin), as on the tree before the registration, and
    no launch counter moves on the CPU."""
    pt.disable_static()
    _, pm, _ = _llama_pair()
    wrappers = launch_counters()
    before = {k: f.launches for k, f in wrappers.items()}
    calls = _plain_calls(monkeypatch)
    ids = torch.as_tensor(_ids()[0])
    loss = pllama.LlamaPretrainingCriterion()(pm(ids), ids)
    n = pm.config.num_hidden_layers
    fwd = {"_ref_rms": 2 * n + 1, "_ref_rms_residual": 2 * n,
           "_rope_ref": n, "_swiglu_ref": n, "_plain_bshd": n}
    assert calls == fwd
    loss.backward()
    assert calls == {**fwd, "_rms_bwd": 2 * n + 1, "_rms_residual_bwd": 2 * n,
                     "rope_bwd_fused": n, "_rope_ref": 2 * n,
                     "swiglu_bwd_fused": n, "flash_attention_bwd_fused": n}
    assert {k: f.launches for k, f in wrappers.items()} == before


def test_an_eager_step_imports_no_dynamo():
    code = (
        "import sys, torch, paddle_tpu_torch\n"
        "from paddle_tpu_torch.models.llama import LlamaForCausalLM, "
        "llama_tiny, LlamaPretrainingCriterion\n"
        "from paddle_tpu_torch.models.generation import greedy_decode\n"
        "from paddle_tpu_torch.optimizer import AdamW\n"
        "m = LlamaForCausalLM(llama_tiny(), device='cpu')\n"
        "ids = torch.randint(0, 512, (2, 16))\n"
        "LlamaPretrainingCriterion()(m(ids), ids).backward()\n"
        "AdamW(parameters=m.parameters()).step()\n"
        "greedy_decode(m, ids[:, :4], 4)\n"
        "sys.exit(1 if 'torch._dynamo' in sys.modules else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
