"""The port's fleet layer in one process (no worker processes):
``paddle_tpu_torch.distributed.rpc`` and ``paddle_tpu_torch.inference.fleet``
against the JAX package's, plus the worker lock the port adds.

Every scenario is one function of a ``FleetSide`` (the JAX package or the
port, on the CPU, each engine over the same weights) and is run on both;
the summaries must be equal.  The scenarios are the in-process ones of
``tests/test_serving_fleet.py``, ``tests/test_ha_control_plane.py`` and
``tests/test_tenancy.py``: an ``RpcTimeout`` typed on a hung handler,
``ServingMetrics.merge`` and the ``replica``-labelled Prometheus page,
``state_summary`` tracked through a ``RemoteReplica`` (an in-process
worker behind a loopback rpc session), a draining replica taking no
placements, a fleet without workers raising cleanly, the autoscaler and
the warm pool over fake spawns, and discovery over a ``KVServer`` (frontend
names and warm workers excluded, a dead endpoint pruned only when it
refuses).

A hand-over during a step (port only; the JAX package's fleet has the
fault this holds): a request handed to a decode ``RemoteReplica`` while
its step RPC is in flight, in the step in which the replica's last
request finishes, is served as an in-process twin stepped at
``begin_step`` serves it, step by step; the step's reply, collected after
the hand-over's, does not take the request out of the replica's mirror.

The worker lock (port only): an engine proxy whose ``step`` sleeps and
records its interval runs beside concurrent ``_w_export_blocks``,
``_w_pull_blocks`` and pulls off the worker's blockwire listener; no
CUDA-issuing handler may overlap a step, and ``_w_health`` answers while
a step runs.  ``build_spec_model``, the workers' recipe, is seeded, casts
to bfloat16 and carries the JAX package's weights (``numpy_state``).
"""
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_control_plane import ENGINE, Side, _diffs

torch.set_num_threads(2)


class FleetSide(Side):
    """A ``Side`` with the package's ``fleet`` and ``rpc`` modules."""

    def __init__(self, name, models):
        super().__init__(name, models)
        self.fleet = importlib.import_module(f"{self.root}.inference.fleet")
        self.rpc = importlib.import_module(f"{self.root}.distributed.rpc")


@pytest.fixture(scope="module")
def sides(serving_model):
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group
    from test_torch_serving import _port_from

    set_hybrid_communicate_group(None)
    return (FleetSide("jax", {"v0": serving_model}),
            FleetSide("port", {"v0": _port_from(serving_model)}))


def both(sides, scenario, **kw):
    got = [scenario(side, **kw) for side in sides]
    assert got[1] == got[0], "\n".join(_diffs(got[0], got[1])[:20])
    return got[1]


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------- scenarios
def rpc_timeout(side):
    """A handler that blocks past the per-call deadline raises the typed
    RpcTimeout, sync and async, instead of freezing the caller."""
    rpc = side.rpc
    rpc.shutdown()
    rpc.init_rpc(f"hung-{side.name}", rank=0, world_size=1)
    out = []
    try:
        t0 = time.monotonic()
        with pytest.raises(rpc.RpcTimeout) as e:
            rpc.rpc_sync(f"hung-{side.name}", time.sleep, args=(3,),
                         timeout=0.3)
        out.append((type(e.value).__name__,
                    isinstance(e.value, TimeoutError)))
        fut = rpc.rpc_async(f"hung-{side.name}", time.sleep, args=(3,),
                            timeout=0.3)
        with pytest.raises(rpc.RpcTimeout) as e:
            fut.wait()
        out.append(type(e.value).__name__)
        assert time.monotonic() - t0 < 5.0
        out.append(rpc.rpc_sync(f"hung-{side.name}", pow, args=(2, 8)))
    finally:
        rpc.shutdown()
    return out


def metrics_merge(side):
    M = side.metrics.ServingMetrics
    a, b = M(Clock()), M(Clock())
    a.inc("tokens_emitted_total", 10)
    b.inc("tokens_emitted_total", 5)
    a.set_gauge_peak("queue_depth", 3)
    b.set_gauge_peak("queue_depth", 7)
    for m, free in ((a, 2), (b, 6)):
        m.set_gauge("blocks_capacity", 8)
        m.set_gauge("blocks_free", free)
    a.set_gauge_peak("block_pool_utilization", 0.75)
    b.set_gauge_peak("block_pool_utilization", 0.25)
    for v in (0.1, 0.2):
        a.observe("ttft_seconds", v)
    for v in (0.3, 0.4, 0.5):
        b.observe("ttft_seconds", v)
    a.inc("admitted_total", 2)
    b.inc("admitted_total", 3)
    merged = M.merge({"w0": a.snapshot(include_samples=True),
                      "w1": b.snapshot(include_samples=True)})
    fallback = M.merge([a.snapshot(), b.snapshot()])
    text = M.prometheus_text_fleet({"w0": a.snapshot(include_samples=True),
                                    "w1": b.snapshot(include_samples=True)})
    return merged, fallback, M.merge({}), text, a.prometheus_text()


def remote_mirror(side):
    """A RemoteReplica over an in-process worker (loopback rpc): after
    every call its mirror (queue, active blocks, free slots and blocks,
    prefix hashes) is the engine's own state."""
    rpc, fleet = side.rpc, side.fleet
    rpc.shutdown()
    eng = side.engine()
    name = "mirror"
    fleet.init_worker(eng, name=name)
    rpc.init_rpc(name, rank=0, world_size=1)
    trail = []

    def look(rep):
        st = eng.state_summary()
        mirror = ([(q.rid, len(q.prompt), q.max_new_tokens)
                   for q in rep._queue],
                  {rid: len(a.blocks) for rid, a in rep._active.items()},
                  len(rep._free_slots), rep.blocks.num_free,
                  sorted(rep.cached_block_hashes()))
        assert mirror == (st["queued"], st["active"], st["free_slots"],
                          st["blocks_free"], st["prefix_cache"]["hashes"])
        trail.append(mirror[:4] + (len(mirror[4]),))

    try:
        rep = fleet.RemoteReplica(name, rpc_timeout=30.0)
        look(rep)
        r1 = rep.add_request(list(range(2, 20)), max_new_tokens=6)
        rep.add_request([42, 5], max_new_tokens=4)
        r3 = rep.add_request([9, 9], max_new_tokens=4)   # B=2: queued
        look(rep)
        out = [rep.step()]
        look(rep)
        rep.evict(r1)
        look(rep)
        while rep.num_active or rep._queue:
            out.append(rep.step())
        look(rep)
        h = rep.health()
        out.append((sorted(rep.pop_finished()), h["name"], h["role"],
                    h["config"]["max_batch_size"], r3))
    finally:
        rpc.shutdown()
    return trail, out


def draining(side):
    """A draining replica finishes in-flight work and takes nothing new;
    with every replica draining, submits are typed-rejected."""
    fe = side.ServingFrontend([side.engine(), side.engine()])
    r1 = fe.submit([3, 17, 101], max_new_tokens=6)
    fe.step()
    drain = next(r for r in fe.replicas if r.requests)
    other = next(r for r in fe.replicas if r is not drain)
    drain.draining = True
    r2 = fe.submit([42, 5], max_new_tokens=4)
    res = dict(fe.run())
    assert drain.requests == {}
    other.draining = True
    r3 = fe.submit([9, 9], max_new_tokens=2)
    res[r3] = fe.result(r3)
    fe.add_replica(side.engine())
    r4 = fe.submit([9, 9], max_new_tokens=2)
    res.update(fe.run())
    return {rid: (r.status.value, list(r.tokens), r.detail)
            for rid, r in sorted(res.items())}, (r1, r2, r3, r4)


def no_workers(side):
    SF = side.fleet.ServingFleet
    fleet = SF.__new__(SF)          # no subprocess spin-up needed
    fleet.frontend = None
    fleet.autoscaler = None
    fleet._spawn_lock = threading.Lock()
    fleet._ready_replicas = []
    fleet._pending_spawns = {}
    out = []
    for fn in (SF.step, SF.run):
        with pytest.raises(RuntimeError, match="no workers") as e:
            fn(fleet)
        out.append(str(e.value))
    SF.heartbeat(fleet)             # probe of an empty fleet: a no-op
    return out


def autoscale_and_pool(side):
    """The autoscaler counts booting workers as capacity; the warm pool's
    breaker gates refills, a faulted attach re-pools, and a generation
    bump refuses a stale boot."""
    fleet, faults = side.fleet, side.faults
    fe = side.ServingFrontend([side.engine()])

    class StubFleet:
        def __init__(self):
            self.frontend = fe
            self.spawned = []
            self.num_pending_spawns = 0

        def spawn_worker_async(self):
            self.num_pending_spawns += 1
            self.spawned.append(f"worker{len(self.spawned) + 1}")
            return self.spawned[-1]

        def drain_replica(self, rep):
            rep.draining = True

    stub = StubFleet()
    auto = fleet.FleetAutoscaler(stub, fleet.AutoscalePolicy(
        min_workers=1, max_workers=2, scale_up_queue_per_replica=1.5,
        up_after=1, down_after=1000, cooldown=0))
    for _ in range(4):
        fe.submit([3, 17, 101], max_new_tokens=4)
    obs = [auto.observe(), auto.observe()]
    stub.num_pending_spawns = 0
    fe.add_replica(side.engine())
    obs.append(auto.observe())
    res = fe.run()
    obs += [list(stub.spawned), list(auto.actions),
            sorted((rid, r.status.value, list(r.tokens))
                   for rid, r in res.items())]

    br = faults.RespawnCircuitBreaker(threshold=2, window_s=100.0,
                                      base_backoff_s=50.0, clock=lambda: 0.0)

    def bad_spawn(name):
        raise RuntimeError("worker died at boot")

    pool = fleet.WarmPool(2, bad_spawn, breaker=br)
    obs += [pool.refill(), pool.refill(), br.allow(), pool.refill(),
            pool.depth()]
    inj = faults.FaultInjector({"pool.attach": {"kind": "error",
                                                "times": 1}}, seed=0)
    pool = fleet.WarmPool(1, lambda name: f"h-{name}", fault_injector=inj)
    obs += [pool.refill(), pool.depth(), pool.claim(), pool.depth(),
            pool.claim(), pool.ready_names()]
    booting = fleet.WarmPool(1, lambda name: None)
    obs += [booting.refill(), booting.depth(), booting.drain_ready(),
            booting.note_ready("warm0", "h"), booting.depth(),
            booting.generation]
    return obs


def discovery(side):
    """``discover_workers`` drops every frontend generation and warm
    workers; ``connect_workers`` prunes an endpoint that refuses and keeps
    one whose probe timed out or whose handler raised."""
    fleet, rpc = side.fleet, side.rpc
    srv = side.master.KVServer(0).start()
    ep = f"127.0.0.1:{srv.port}"
    kv = side.master.KVClient(ep)
    out = []
    rpc.shutdown()
    try:
        for name, port in (("w0", 1), ("w1", 2), ("fleet-frontend", 3),
                           ("frontend-a", 4), ("standby-frontend", 5),
                           ("warm0", 6)):
            kv.put(f"/rpc/workers/{name}", f"0:127.0.0.1:{port}")
        kv.put("/serving/warm/warm0", "1")
        kv.put("/serving/roles/w1", "decode")
        kv.put("/serving/wire/w1", "127.0.0.1:9")
        out += [fleet.discover_workers(ep),
                fleet.discover_workers(ep, exclude=("w0",)),
                fleet.worker_roles(ep)]
        out.append(fleet.worker_wires(ep))
        with pytest.raises(ValueError, match="frontend"):
            fleet.init_worker(side.engine(), name="frontend-gpu0")
        rpc.init_rpc(f"test-{side.name}-frontend", rank=0, world_size=1,
                     master_endpoint=ep)
        kv.delete("/rpc/workers/w0")
        kv.delete("/rpc/workers/warm0")
        kv.delete("/serving/warm/warm0")
        # w1: a SIGKILLed worker's stale entry, nothing at its port
        out.append([r.worker for r in
                    fleet.connect_workers(ep, rpc_timeout=2.0)])
        out.append(kv.get("/rpc/workers/w1"))

        def remote_reset():
            e = ConnectionResetError("injected by health.probe")
            e._rpc_remote = True
            return e

        real = fleet.RemoteReplica
        for make in (lambda: rpc.RpcTimeout("probe timed out"),
                     lambda: RuntimeError("health.probe injected"),
                     remote_reset,
                     lambda: ConnectionResetError("transient local blip")):
            class Probe:
                def __init__(self, name, make=make, **kw):
                    raise make()

            fleet.RemoteReplica = Probe
            try:
                kv.put("/rpc/workers/w-alive", "0:127.0.0.1:1")
                out.append((fleet.connect_workers(ep, rpc_timeout=2.0),
                            kv.get("/rpc/workers/w-alive")))
            finally:
                fleet.RemoteReplica = real
    finally:
        rpc.shutdown()
        srv.stop()
    return out


# ------------------------------------------------------------------- tests
def test_rpc_timeout_is_typed(sides):
    got = both(sides, rpc_timeout)
    assert got == [("RpcTimeout", True), "RpcTimeout", 256]


def test_metrics_merge_and_fleet_labels(sides):
    merged, fallback, empty, text, single = both(sides, metrics_merge)
    assert merged["counters"]["tokens_emitted_total"] == 15
    assert merged["gauges"]["queue_depth"] == 10
    assert merged["gauges"]["queue_depth_peak"] == 7
    assert merged["percentiles_exact"]
    assert not fallback["percentiles_exact"]
    assert empty["num_replicas"] == 0
    assert 'paddle_tpu_serving_admitted_total{replica="w1"} 3' in text
    assert "paddle_tpu_serving_admitted_total 2" in single


def test_state_summary_tracked_through_remote_replica(sides):
    trail, out = both(sides, remote_mirror)
    assert trail[1][0] and trail[-1][:2] == ([], {})
    assert out[-1][1:4] == ("mirror", None, ENGINE["max_batch_size"])


def test_draining_replica_takes_no_placements(sides):
    res, rids = both(sides, draining)
    assert res[rids[2]][0] == "overloaded" and "draining" in res[rids[2]][2]
    assert all(res[r][0] == "completed" for r in (rids[0], rids[1], rids[3]))


def test_fleet_without_workers_raises_cleanly(sides):
    both(sides, no_workers)


def test_autoscaler_and_warm_pool_over_fake_spawns(sides):
    obs = both(sides, autoscale_and_pool)
    assert obs[:3] == ["up", "hold", "hold"] and obs[3] == ["worker1"]


def test_discovery_over_a_kv_server(sides):
    out = both(sides, discovery)
    assert out[0] == ["w0", "w1"] and out[1] == ["w1"]
    assert out[4] == [] and out[5] is None          # refused: pruned
    assert all(reps == [] and entry is not None for reps, entry in out[6:])


# ------------------------------------------ a hand-over during a step
class _Stepped:
    """An in-process engine stepped as a ``RemoteReplica`` is:
    ``begin_step`` runs the step, ``step`` hands its result over, and a
    call in between lands after the step.  ``idle_handoffs`` counts the
    requests handed over after a step that left the engine without
    work."""

    def __init__(self, eng):
        self._eng = eng
        self._done = None
        self.idle_handoffs = 0

    def __getattr__(self, attr):
        return getattr(self._eng, attr)

    def begin_step(self):
        if self._done is None:
            self._done = self._eng.step()

    def step(self):
        out, self._done = self._done, None
        return self._eng.step() if out is None else out

    def add_request(self, *args, **kwargs):
        if self._done is not None and not (self._eng.num_active
                                           or self._eng._queue):
            self.idle_handoffs += 1
        return self._eng.add_request(*args, **kwargs)


def handoff_run(port, decode, second_at):
    """A prefill engine in process and ``decode`` behind one frontend;
    request A first, request B submitted before step ``second_at``.
    Returns the tokens emitted after each step and the results."""
    prefill = port.engine()
    prefill.role = "prefill"
    fe = port.ServingFrontend([prefill, decode], kv_fabric=port.kv_fabric
                              .KVFabric(port.kv_fabric.MemoryKV()))
    fe.submit(list(range(2, 22)), max_new_tokens=12)
    trail = []
    for i in range(40):
        if i == second_at:
            fe.submit(list(range(30, 42)), max_new_tokens=6)
        elif i > second_at and not fe.pending:
            break
        fe.step()
        trail.append(fe.metrics.counter("tokens_emitted_total"))
    return trail, {rid: (r.status.value, list(r.tokens))
                   for rid, r in sorted(fe.results().items())}


def test_handoff_to_a_decode_replica_idle_after_its_step(sides):
    port = sides[1]
    rpc, fleet = port.rpc, port.fleet
    # the step before which B is submitted so that its hand-over reaches
    # the decode replica in the step that finishes A there
    for second_at in range(1, 12):
        twin = _Stepped(port.engine())
        twin.role = "decode"
        want = handoff_run(port, twin, second_at)
        if twin.idle_handoffs:
            break
    else:
        pytest.fail("no hand-over reached an idle decode replica")
    rpc.shutdown()
    name = "handoff"
    fleet.init_worker(port.engine(), name=name, role="decode")
    rpc.init_rpc(name, rank=0, world_size=1)
    try:
        rep = fleet.RemoteReplica(name, rpc_timeout=30.0)
        got = handoff_run(port, rep, second_at)
    finally:
        rpc.shutdown()
    assert got == want
    assert [st for st, _ in want[1].values()] == ["completed"] * 2


# ------------------------------------------------------- the worker lock
class _Recorder:
    """An engine proxy recording the interval of every CUDA-issuing call;
    ``step`` sleeps first, so a handler that ignored the lock would land
    inside it."""

    def __init__(self, eng, nap):
        self._eng = eng
        self._nap = nap
        self.intervals = []
        self.stepping = threading.Event()

    def __getattr__(self, attr):
        return getattr(self._eng, attr)

    def _timed(self, kind, fn, *args):
        t0 = time.monotonic()
        try:
            return fn(*args)
        finally:
            self.intervals.append((kind, t0, time.monotonic()))

    def step(self):
        def run():
            self.stepping.set()
            time.sleep(self._nap)
            out = self._eng.step()
            self.stepping.clear()
            return out
        return self._timed("step", run)

    def export_blocks(self, hashes):
        return self._timed("export", self._eng.export_blocks, hashes)

    def export_blocks_packed(self, hashes):
        return self._timed("listener", self._eng.export_blocks_packed,
                           hashes)

    def import_blocks_packed(self, header, raw):
        return self._timed("import", self._eng.import_blocks_packed,
                           header, raw)


def test_worker_lock_serialises_cuda_work(sides):
    from paddle_tpu_torch.inference import fleet
    from paddle_tpu_torch.inference.blockwire import (BlockWireServer,
                                                      default_pool)
    from paddle_tpu_torch.inference.serving import prompt_block_hashes

    port = sides[1]
    prompt = list(range(2, 26))                 # 3 full blocks at bs 8
    hashes = prompt_block_hashes(prompt, ENGINE["block_size"])
    # the peer holds the chain the worker pulls; the worker holds it too,
    # for its own exports and its listener's
    peer, inner = port.engine(), port.engine()
    for e in (peer, inner):
        e.add_request(prompt, max_new_tokens=1)
        e.run()
    nap = 0.4
    eng = _Recorder(inner, nap=nap)
    fleet.init_worker(eng, name="w-lock")
    peer_srv = BlockWireServer(peer)
    own_srv = BlockWireServer(eng, fence=fleet._WORKER["fence"],
                              lock=fleet._WORKER["lock"])
    errors, health = [], []

    def loop(fn):
        def run():
            try:
                for _ in range(6):
                    fn()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
        return threading.Thread(target=run)

    def probe():
        eng.stepping.wait(timeout=10)
        h = fleet._w_health()
        health.append((eng.stepping.is_set(), h["name"]))

    threads = [loop(fleet._w_step),
               loop(lambda: fleet._w_export_blocks(hashes)),
               loop(lambda: fleet._w_pull_blocks(peer_srv.endpoint, hashes)),
               loop(lambda: default_pool().pull(own_srv.endpoint, hashes)),
               threading.Thread(target=probe)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        peer_srv.close()
        own_srv.close()
    assert not errors, errors
    steps = [(a, b) for k, a, b in eng.intervals if k == "step"]
    others = [(k, a, b) for k, a, b in eng.intervals if k != "step"]
    assert len(steps) == 6
    assert {k for k, _, _ in others} == {"export", "listener", "import"}
    overlaps = [(k, a, b) for k, a, b in others
                for s0, s1 in steps if a < s1 and s0 < b]
    assert not overlaps, f"CUDA-issuing calls inside a step: {overlaps}"
    # the heartbeat's probe answered while a step held the lock
    assert health == [(True, "w-lock")]


def test_build_spec_model_carries_jax_weights(sides, tmp_path):
    """The worker-spec recipe: seeded, optionally cast to bfloat16 (the
    config says so, so an engine computes in it), and with
    ``numpy_state`` the JAX package's weights bit for bit."""
    from paddle_tpu_torch.inference.fleet import build_spec_model

    jax_model = sides[0].models["v0"]
    sd = {k: np.asarray(v._value) for k, v in jax_model.state_dict().items()}
    np.savez(tmp_path / "state.npz", **sd)
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
              num_hidden_layers=1, num_attention_heads=2,
              max_position_embeddings=256)
    a = build_spec_model(kw, 11, device="cpu")
    b = build_spec_model(kw, 11, device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    loaded = build_spec_model(kw, 11, device="cpu",
                              numpy_state=str(tmp_path / "state.npz"))
    for k, v in loaded.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    assert not loaded.training
    half = build_spec_model(kw, 11, bfloat16=True, device="cpu")
    assert half.config.dtype == "bfloat16"
    assert {p.dtype for p in half.parameters()} == {torch.bfloat16}
    for x, y in zip(half.parameters(), a.parameters()):
        assert torch.equal(x, y.to(torch.bfloat16))
