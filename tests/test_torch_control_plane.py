"""The port's serving control plane (``paddle_tpu_torch.inference``:
``ServingFrontend``, ``ServingMetrics``, tracing, tenancy) over the port's
``ServingEngine`` against the reference's frontend over the JAX engine.

Every scenario is one function of a ``Side`` (the JAX package or the
port, each with its own engine over the same weights, on the CPU) and is
run on both: the requests' statuses, tokens, details, preemptions and
attempts, the frontend's metrics counters and gauges (all but the host
seconds of the step phases), and the trace stream's
``events_digest`` (timestamps excluded, an injected clock) must be equal.
The scenarios are those of ``tests/test_serving_control_plane.py``,
``tests/test_tracing.py``, ``tests/test_fault_containment.py`` (brownout)
and ``tests/test_tenancy.py``: admission caps, cancel (queued and
running), deadlines (mid-queue, and mid-generation with an injected
``deadline_token_seconds``), the preemption round trip, a replica killed
through a failpoint (retries, then poison quarantine), every replica
dead, least-loaded and prefix-affinity routing, brownout, tenant DRR with
budgets, and a tenant's model swapped in.  Logprobs, where a request asks
for them, agree within 1e-5 (float32 sums in another order).
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as P
from test_torch_serving import _port_from

torch.set_num_threads(2)

ENGINE = dict(max_batch_size=2, max_seq_len=64, block_size=8,
              token_budget=16)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Counter:
    """A clock that ticks once a read (the tracing tests' clock)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


class Side:
    """One package's serving stack: ``jax`` (paddle_tpu over the JAX
    engine) or ``port`` (paddle_tpu_torch over the port's engine, on the
    CPU), each module reachable by its name (``side.control_plane``)."""

    MODULES = ("control_plane", "metrics", "tracing", "tenancy", "journal",
               "ha", "faults", "kv_fabric", "blockwire", "serving")

    def __init__(self, name, models):
        self.name = name
        self.root = "paddle_tpu" if name == "jax" else "paddle_tpu_torch"
        self.models = models          # {label: model of this package}
        for m in self.MODULES:
            setattr(self, m, importlib.import_module(
                f"{self.root}.inference.{m}"))
        self.master = importlib.import_module(
            f"{self.root}.distributed.launch.master")
        cp = self.control_plane
        self.ServingFrontend = cp.ServingFrontend
        self.Priority = cp.Priority
        self.RequestStatus = cp.RequestStatus
        self.BrownoutPolicy = cp.BrownoutPolicy

    def engine(self, model="v0", **kw):
        merged = {**ENGINE, **kw}
        if self.name == "port":
            merged.setdefault("device", "cpu")
        return self.serving.ServingEngine(self.models[model], **merged)


def make_sides(serving_model):
    """Both packages over the shared ``serving_model`` fixture ("v0") and
    a second model of the same geometry ("v2", seed 13), the port's from
    the same weights."""
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    set_hybrid_communicate_group(None)
    P.seed(13)
    v2 = LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=160,
        num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=256))
    v2.eval()
    jax_models = {"v0": serving_model, "v2": v2}
    port_models = {k: _port_from(m) for k, m in jax_models.items()}
    return Side("jax", jax_models), Side("port", port_models)


@pytest.fixture(scope="module")
def sides(serving_model):
    return make_sides(serving_model)


def summary(side, fe, res, tracer=None):
    """What both packages must agree on after a run."""
    out = {}
    for rid, r in sorted(res.items()):
        out[rid] = (r.status.value, [int(t) for t in r.tokens], r.detail,
                    r.preemptions, r.attempts, r.weights_version, r.tenant)
    snap = fe.metrics.snapshot()
    counters = {k: v for k, v in snap["counters"].items()
                if "seconds" not in k}
    gauges = {k: v for k, v in snap["gauges"].items()
              if "seconds" not in k}
    digest = (side.tracing.events_digest(tracer.recorder.snapshot())
              if tracer is not None else None)
    return {"results": out, "counters": counters, "gauges": gauges,
            "digest": digest}


def _diffs(a, b, path=""):
    """The paths where two nested results differ, for the message."""
    if isinstance(a, dict) and isinstance(b, dict):
        return [d for k in sorted(set(a) | set(b), key=str)
                for d in _diffs(a.get(k), b.get(k), f"{path}[{k!r}]")]
    if (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
            and len(a) == len(b)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _diffs(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: jax {a!r}, port {b!r}"]


def both(sides, scenario, **kw):
    """Run ``scenario(side, **kw)`` on both packages: the two summaries
    must be equal; returns the port's (for the scenario's own checks)."""
    got = [scenario(side, **kw) for side in sides]
    assert got[1] == got[0], "\n".join(_diffs(got[0], got[1])[:20])
    return got[1]


# --------------------------------------------------------------- scenarios
def admission_caps(side):
    """Queue-length and capacity caps, then the queued-token cap."""
    fe = side.ServingFrontend([side.engine()], max_queue_requests=2)
    for _ in range(3):
        fe.submit([3, 17], max_new_tokens=4)
    fe.submit(list(range(1, 60)), max_new_tokens=30)   # never fits
    res = dict(fe.run())
    fe2 = side.ServingFrontend([side.engine()], max_queue_tokens=30)
    fe2.submit([3, 17, 101], max_new_tokens=8)
    fe2.submit([42, 5], max_new_tokens=8)
    fe2.submit([250, 4, 9], max_new_tokens=12)         # over 30: shed
    res2 = fe2.run()
    return [summary(side, fe, res), summary(side, fe2, res2)]


def cancel_queued_and_running(side):
    fe = side.ServingFrontend([side.engine(max_batch_size=1)])
    r1 = fe.submit([3, 17, 101], max_new_tokens=10)
    r2 = fe.submit([42, 5], max_new_tokens=4)
    fe.step()
    fe.step()
    flags = (fe.cancel(r2), fe.cancel(r1), fe.cancel(r1))
    res = fe.run()
    eng = fe.replicas[0].engine
    return (flags, summary(side, fe, res), eng.num_active,
            eng.blocks.num_free == eng.blocks.num_blocks)


def deadlines(side):
    """Mid-queue (the frontend's clock passes the deadline), then
    mid-generation: the engine, on the same injected clock with a pinned
    ``deadline_token_seconds``, freezes the row inside its loop."""
    clock = FakeClock()
    fe = side.ServingFrontend([side.engine(max_batch_size=1)], clock=clock)
    fe.submit([3, 17, 101], max_new_tokens=8)
    fe.submit([42, 5], max_new_tokens=4, deadline_s=1.0)
    fe.step()
    clock.advance(2.0)
    res = fe.run()
    clock2 = FakeClock()
    eng = side.engine(clock=clock2, deadline_token_seconds=1.0)
    fe2 = side.ServingFrontend([eng], clock=clock2)
    fe2.submit([3, 17, 101, 7], max_new_tokens=12, deadline_s=5.0)
    fe2.submit([42, 5], max_new_tokens=12)
    fe2.step()
    fe2.step()
    clock2.advance(10.0)
    res2 = fe2.run()
    return [summary(side, fe, res), summary(side, fe2, res2)]


def preemption_round_trip(side):
    """Pool exhaustion evicts LOW for HIGH; the resumed LOW request ends
    with the unpreempted tokens; traced, on a ticking clock."""
    clk = Counter()
    tracer = side.tracing.Tracer(clock=clk, proc="frontend")
    rec = side.tracing.FlightRecorder(clock=clk, proc="engine")
    eng = side.engine(max_seq_len=32, num_blocks=4, trace_recorder=rec,
                      clock=clk)
    fe = side.ServingFrontend([eng], tracer=tracer)
    rlo = fe.submit([3, 17, 101], max_new_tokens=8,
                    priority=side.Priority.LOW, logprobs=True)
    fe.step()
    rhi = fe.submit(list(range(40, 50)), max_new_tokens=8,
                    priority=side.Priority.HIGH)
    res = fe.run()
    tree = tracer.tree_for(side.tracing.TraceContext.mint(rlo).trace_id)
    complete = side.tracing.tree_complete(tree)
    lp = np.asarray(res[rlo].logprobs, np.float64)
    return (summary(side, fe, res, tracer), complete,
            res[rlo].preemptions, rhi), lp


def failpoint_kill(side):
    """A failpoint kills the replicas a poison prompt lands on: the
    collateral requests re-queue onto survivors, the poison one is
    quarantined after its retry budget; traced."""
    clk = Counter()
    tracer = side.tracing.Tracer(clock=clk, proc="frontend")
    inj = side.faults.FaultInjector({"engine.step": {"kind": "error",
                                                     "match": "p66-6-6-"}})
    engines = [side.faults.FaultyReplica(side.engine(), inj, name=f"r{i}")
               for i in range(3)]
    fe = side.ServingFrontend(engines, max_request_retries=1, tracer=tracer)
    fe.submit([66, 6, 6], max_new_tokens=4)
    fe.submit([3, 17, 101], max_new_tokens=6)
    fe.submit([42, 5, 7], max_new_tokens=6)
    res = fe.run()
    alive = [r.alive for r in fe.replicas]
    return summary(side, fe, res, tracer), alive


def all_dead(side):
    fe = side.ServingFrontend([side.engine()])
    for _ in range(3):
        fe.submit([3, 17, 101], max_new_tokens=6)
    fe.step()

    def boom():
        raise RuntimeError("injected")

    fe.replicas[0].engine.step = boom
    res = dict(fe.run())
    late = fe.submit([5, 6], max_new_tokens=2)
    res[late] = fe.result(late)
    return summary(side, fe, res)


def routing(side):
    """Least-loaded spreading, then prefix affinity: a prompt sharing a
    warm replica's two cached blocks goes there."""
    fe = side.ServingFrontend([side.engine(), side.engine()])
    for i in range(4):
        fe.submit([3 + i, 17], max_new_tokens=4)
    fe.step()
    loads = [len(r.requests) for r in fe.replicas]
    res = fe.run()
    prefix = [(5 * i + 1) % 250 + 1 for i in range(16)]
    fe2 = side.ServingFrontend([side.engine(), side.engine()])
    first = fe2.submit(prefix + [9], max_new_tokens=3)
    fe2.run()
    warm = [i for i, r in enumerate(fe2.replicas)
            if r.engine.cached_block_hashes()]
    again = [fe2.submit(prefix + [7 + i], max_new_tokens=3)
             for i in range(2)]
    fe2.step()
    placed = [[rid in r.requests for r in fe2.replicas] for rid in again]
    res2 = fe2.run()
    return (loads, summary(side, fe, res), warm, placed, first,
            summary(side, fe2, res2))


def brownout(side):
    pol = side.BrownoutPolicy(queue_high=2.0, queue_low=0.5, enter_after=2,
                              exit_after=3, normal_max_new_tokens=3)
    fe = side.ServingFrontend(
        [side.engine(max_batch_size=1)], brownout=pol, clock=FakeClock())
    for i in range(6):
        fe.submit([3 + i, 17], max_new_tokens=4)
    levels = []
    for _ in range(2):
        fe.step()
        levels.append(fe.brownout_level)
    fe.submit([9, 9], max_new_tokens=2, priority=side.Priority.LOW)
    for _ in range(2):
        fe.step()
        levels.append(fe.brownout_level)
    fe.submit([40, 41], max_new_tokens=10)
    fe.submit([50, 51], max_new_tokens=10, priority=side.Priority.HIGH)
    res = dict(fe.run())
    for _ in range(8):
        fe.step()
    levels.append(fe.brownout_level)
    for rid in range(-1, -3, -1):
        if fe.result(rid) is not None:
            res[rid] = fe.result(rid)
    return levels, summary(side, fe, res)


def tenants(side):
    """Budgets (a typed rejection, released at completion), DRR across
    tenants of different weights, and a tenant whose model a replica
    swaps in on demand."""
    T = side.tenancy
    reg = T.TenantRegistry([T.TenantSpec("steady", weight=1.0),
                            T.TenantSpec("heavy", weight=3.0),
                            T.TenantSpec("bursty", token_budget=10)])
    fe = side.ServingFrontend([side.engine(max_batch_size=1)], tenants=reg)
    order = []                  # rids in the order their first token came

    def first(rid, tok):
        if rid not in order:
            order.append(rid)

    for i in range(3):
        fe.submit([3 + i, 17], max_new_tokens=3, tenant="steady",
                  on_token=first)
        fe.submit([30 + i, 7], max_new_tokens=3, tenant="heavy",
                  on_token=first)
    fe.submit([5, 6], max_new_tokens=4, tenant="bursty", on_token=first)
    fe.submit([5, 6, 7], max_new_tokens=4, tenant="bursty")   # over budget
    res = dict(fe.run())
    again = fe.submit([5, 6, 7], max_new_tokens=4, tenant="bursty")
    res.update(fe.run())
    reg2 = T.TenantRegistry([T.TenantSpec("a", model_id="m2")],
                            model_provider={"m2": side.models["v2"]}.get)
    engines = [side.engine(), side.engine()]
    fe2 = side.ServingFrontend(engines, tenants=reg2)
    fe2.submit([42, 5], max_new_tokens=5, tenant="a")
    fe2.submit([3, 17, 101], max_new_tokens=5)
    res2 = fe2.run()
    snap = reg.snapshot()
    return (summary(side, fe, res), again, order, snap,
            summary(side, fe2, res2), sorted(e.model_id for e in engines))


# ------------------------------------------------------------------- tests
def test_admission_caps(sides):
    a, b = both(sides, admission_caps)
    st = {rid: r[0] for rid, r in a["results"].items()}
    assert st == {-2: "overloaded", -1: "overloaded", 0: "completed",
                  1: "completed"}
    assert a["counters"]["rejected_overloaded_total"] == 2
    assert sorted(r[0] for r in b["results"].values()) == [
        "completed", "completed", "overloaded"]


def test_cancel_queued_and_running(sides):
    flags, s, active, drained = both(sides, cancel_queued_and_running)
    assert flags == (True, True, False) and active == 0 and drained
    assert [r[0] for r in s["results"].values()] == ["cancelled"] * 2


def test_deadlines(sides):
    q, g = both(sides, deadlines)
    st = {rid: r[0] for rid, r in q["results"].items()}
    assert sorted(st.values()) == ["completed", "deadline_exceeded"]
    assert q["counters"]["shed_deadline_total"] == 1
    frozen = [r for r in g["results"].values()
              if r[0] == "deadline_exceeded"]
    assert frozen and 0 < len(frozen[0][1]) < 12


def test_preemption_round_trip_and_its_trace(sides):
    (jax_out, jax_lp), (port_out, port_lp) = (preemption_round_trip(s)
                                              for s in sides)
    assert port_out == jax_out
    s, complete, preemptions, _ = port_out
    assert complete == (True, "") and preemptions >= 1
    assert s["counters"]["preempted_total"] >= 1
    assert s["digest"] is not None
    np.testing.assert_allclose(port_lp, jax_lp, rtol=1e-5, atol=1e-5)


def test_replica_killed_through_a_failpoint(sides):
    s, alive = both(sides, failpoint_kill)
    st = [r[0] for r in s["results"].values()]
    assert st[0] == "failed_poison" and st[1:] == ["completed"] * 2
    assert alive.count(False) == 2
    assert s["counters"]["replica_deaths_total"] == 2


def test_all_replicas_dead(sides):
    s = both(sides, all_dead)
    assert {r[0] for r in s["results"].values()} == {"failed"}
    assert len(s["results"]) == 4


def test_least_loaded_and_prefix_affinity_routing(sides):
    loads, _, warm, placed, _, s2 = both(sides, routing)
    assert loads == [2, 2]
    assert len(warm) == 1
    assert all(p[warm[0]] for p in placed)
    assert {r[0] for r in s2["results"].values()} == {"completed"}


def test_brownout(sides):
    levels, s = both(sides, brownout)
    assert levels == [0, 1, 1, 2, 0]
    assert s["counters"]["shed_brownout_total"] == 1
    assert s["counters"]["brownout_capped_total"] == 1


def test_tenant_drr_budgets_and_model_swap(sides):
    s, again, order, snap, s2, models = both(sides, tenants)
    st = [r[0] for r in s["results"].values()]
    assert st.count("overloaded") == 1 and again >= 0
    assert s["counters"]["tenant_rejected_budget_total"] == 1
    assert snap["heavy"]["served"] > 0 and snap["steady"]["served"] > 0
    assert models == ["default", "m2"]
    assert s2["counters"]["weight_swaps_total"] == 1


def test_metrics_snapshot_and_prometheus_text(sides):
    """The same run's snapshot counters and the Prometheus text's metric
    names and counter lines agree; the text parses line by line."""
    texts = []
    for side in sides:
        fe = side.ServingFrontend([side.engine()])
        fe.submit([3, 17, 101, 7], max_new_tokens=8)
        fe.submit([42, 5], max_new_tokens=8)
        fe.run()
        text = fe.metrics.prometheus_text()
        lines = [ln for ln in text.splitlines()
                 if ln and not ln.startswith("#")]
        for ln in lines:
            name, value = ln.rsplit(" ", 1)
            float(value)
            assert name.startswith("paddle_tpu_serving_")
        texts.append(sorted(ln for ln in lines if "_total " in ln
                            and "seconds" not in ln))
    assert texts[1] == texts[0]
    assert "paddle_tpu_serving_admitted_total 2" in texts[1]
