"""The port's serving fleet over real worker processes
(``paddle_tpu_torch.tools.serving_worker``, ``--device cpu``) on the JAX
package's weights (the spec's ``numpy_state``), held against the JAX
package's in-process ``ServingFrontend`` over its own engines.

At the reference's sub-tiny geometry (``tests/test_serving_fleet.py``),
float32, so tokens are held exactly:

* a two-worker fleet gives the JAX frontend's statuses, tokens and
  logprobs (greedy, and one seeded sampled request); an engine rejection
  comes back typed; a class token budget holds fleet-wide; a worker
  SIGKILLed mid-generation drops nothing and the survivors' tokens are the
  JAX ones; ``spawn_worker_async`` attaches on ``step``; a SIGSTOPped
  worker is found by the heartbeat;
* the autoscaler scales up under pressure by claiming a ``--warm`` worker
  from the ``WarmPool``, then drains back to one worker;
* prefill / decode roles with ``"wire": true``: chains pulled worker to
  worker over blockwire are bit-equal to the relay's payload, a port
  worker pulls a chain off a JAX engine's ``BlockWireServer`` in this
  process bit for bit, a disaggregated frontend over the fleet gives the
  JAX tokens with every pull on the wire, and a ``rolling_swap`` to
  another version's weights gives that version's JAX tokens;
* workers spawned with the default ``cpu_workers`` on this machine
  without CUDA fail their boot with the device module's ``RuntimeError``
  and never serve on the CPU.

Every spawn carries its own deadline (``spawn_timeout`` 60 s) and every
wait a bounded loop; spawned CPU workers run with ``OMP_NUM_THREADS=1``.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.inference import Priority as JPriority
from paddle_tpu.inference import ServingEngine as JEngine
from paddle_tpu.inference import ServingFrontend as JFrontend
from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.inference import (AutoscalePolicy, Priority,
                                        RequestStatus, ServingFleet)

torch.set_num_threads(2)

MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_hidden_layers=1, num_attention_heads=2,
             max_position_embeddings=256)
ENGINE = dict(max_batch_size=2, max_seq_len=64, block_size=8,
              token_budget=16)
PROMPTS = [[3, 17, 101, 7, 250], [42, 5], [250, 4, 9], [88, 13, 77]]
SAMPLED = dict(temperature=0.8, top_k=16, top_p=0.95, seed=7)
DEADLINE = 60.0


def _save_state(model, path):
    np.savez(path, **{k: np.asarray(v._value)
                      for k, v in model.state_dict().items()})
    return str(path)


@pytest.fixture(scope="module")
def weights(serving_model, tmp_path_factory):
    """The JAX models (v0: the session's serving model, seed 11; v2: seed
    13) and the .npz files of their state_dicts."""
    from paddle_tpu.distributed.topology import set_hybrid_communicate_group
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM

    set_hybrid_communicate_group(None)
    P.seed(13)
    v2 = LlamaForCausalLM(LlamaConfig(**MODEL))
    v2.eval()
    d = tmp_path_factory.mktemp("fleet_weights")
    return {"v0": (serving_model, _save_state(serving_model, d / "v0.npz")),
            "v2": (v2, _save_state(v2, d / "v2.npz"))}


def spec(weights, version="v0", **extra):
    return {"seed": 11, "model": MODEL, "engine": ENGINE,
            "numpy_state": weights[version][1], **extra}


def make_fleet(weights, num_workers, version="v0", spec_extra=None, **kw):
    kw.setdefault("heartbeat_interval_s", 10.0)
    rpc.shutdown()               # a leaked session would refuse init
    return ServingFleet(spec(weights, version, **(spec_extra or {})),
                        num_workers=num_workers, cpu_workers=True,
                        spawn_timeout=DEADLINE, **kw)


def jax_results(model, traffic, replicas=2, **fe_kw):
    """The JAX package's in-process frontend over ``replicas`` engines:
    {index: (status, tokens, logprobs)}."""
    fe = JFrontend([JEngine(model, **ENGINE) for _ in range(replicas)],
                   **fe_kw)
    rids = [fe.submit(p, max_new_tokens=n,
                      priority=JPriority[prio], **kw)
            for p, n, prio, kw in traffic]
    res = fe.run()
    return outcome(res, rids)


def port_results(fleet, traffic):
    rids = [fleet.frontend.submit(p, max_new_tokens=n,
                                  priority=Priority[prio], **kw)
            for p, n, prio, kw in traffic]
    res = fleet.run()
    return outcome(res, rids)


def outcome(res, rids):
    return {i: (res[r].status.value, [int(t) for t in res[r].tokens],
                None if res[r].logprobs is None
                else np.asarray(res[r].logprobs, np.float64))
            for i, r in enumerate(rids)}


def assert_same(got, want):
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i][:2] == want[i][:2], (i, got[i], want[i])
        if want[i][2] is None:
            assert got[i][2] is None
        else:
            np.testing.assert_allclose(got[i][2], want[i][2], atol=1e-5)


def wait_for(cond, what, step=None):
    deadline = time.monotonic() + DEADLINE
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        if step is not None:
            step()
        time.sleep(0.05)


TRAFFIC = ([(p, 6, "HIGH" if i % 2 else "NORMAL", {})
            for i, p in enumerate(PROMPTS)]
           + [([9, 8, 7, 6], 6, "NORMAL", dict(SAMPLED, logprobs=True))])


def test_fleet_matches_jax_frontend_and_survives_faults(weights):
    jax_model = weights["v0"][0]
    budgets = {"LOW": 24}
    want = jax_results(jax_model, TRAFFIC, class_token_budgets={
        JPriority[k]: v for k, v in budgets.items()})
    with make_fleet(weights, 2, frontend_kwargs={"class_token_budgets": {
            Priority[k]: v for k, v in budgets.items()}}) as fleet:
        assert fleet.cpu_workers and len(fleet.workers) == 2
        # parity, greedy and seeded sampled, spread over both workers
        assert_same(port_results(fleet, TRAFFIC), want)
        assert fleet.frontend.metrics.gauge("replicas_alive") == 2

        # an engine rejection (longer than max_seq_len) comes back typed
        fe = fleet.frontend
        r = fe.submit(list(range(1, 60)), max_new_tokens=30)
        assert fe.result(r).status is RequestStatus.OVERLOADED

        # the class budget binds across workers: 11 + 10 fit in 24, the
        # third LOW request does not; HIGH is uncapped
        low = [fe.submit(p, max_new_tokens=8, priority=Priority.LOW)
               for p in ([3, 17, 101], [42, 5], [250, 4])]
        over = fe.result(low[2])
        assert over.status is RequestStatus.OVERLOADED
        assert "class LOW token budget" in over.detail
        hi = fe.submit([9, 9], max_new_tokens=4, priority=Priority.HIGH)
        res = fleet.run()
        assert res[low[0]].ok and res[low[1]].ok and res[hi].ok
        again = fe.submit([7, 8], max_new_tokens=4, priority=Priority.LOW)
        assert fleet.run()[again].ok          # released on completion

        # SIGKILL a worker after its first tokens: nothing dropped, the
        # survivors' tokens are the JAX ones
        greedy = TRAFFIC[:4]
        rids = [fe.submit(p, max_new_tokens=n, priority=Priority[prio])
                for p, n, prio, _ in greedy]
        fleet.step()                          # prefill + first token
        doomed = next(r for r in fe.replicas if r.requests)
        name = doomed.engine.worker
        on_doomed = len(doomed.requests)
        os.kill(doomed.engine.pid, signal.SIGKILL)
        res = fleet.run()
        for i, rid in enumerate(rids):
            assert res[rid].status is RequestStatus.COMPLETED
            assert list(res[rid].tokens) == want[i][1]
        m = fe.metrics
        assert m.counter("replica_deaths_total") == 1
        assert m.counter("requeued_on_failover_total") == on_doomed
        assert name not in fleet.workers and name not in fleet._procs

        # scale back up without blocking the step loop
        t0 = time.monotonic()
        new = fleet.spawn_worker_async()
        assert time.monotonic() - t0 < 1.0
        wait_for(lambda: not fleet.num_pending_spawns, "the async spawn",
                 step=fleet.step)
        # (the SIGKILLed worker's early death is a recorded spawn error)
        assert list(fleet.spawn_errors) == [name] and new in fleet.workers
        # a SIGSTOPped worker stops answering: the heartbeat fails it over
        fleet.heartbeat_timeout_s = 3.0
        fleet.heartbeat_retries = 0
        stopped = next(r for r in fe.replicas
                       if r.alive and r.engine.worker == new)
        os.kill(stopped.engine.pid, signal.SIGSTOP)
        try:
            fleet.heartbeat()
            assert not stopped.alive
            assert "timed out" in str(stopped.last_error)
        finally:
            os.kill(stopped.engine.pid, signal.SIGCONT)
        fleet.step()                          # reaps the stopped worker
        assert fleet.workers == [w for w in fleet.workers if w != new]
        assert_same(port_results(fleet, TRAFFIC[:2]),
                    {i: want[i] for i in range(2)})


def test_autoscaler_claims_a_warm_worker_then_drains(weights):
    pol = AutoscalePolicy(min_workers=1, max_workers=2,
                          scale_up_queue_per_replica=1.5, up_after=2,
                          down_after=4, cooldown=1)
    traffic = [([3 + i, 17, 101], 6, "NORMAL", {}) for i in range(6)]
    want = jax_results(weights["v0"][0], traffic, replicas=1)
    with make_fleet(weights, 1, autoscaler_policy=pol,
                    warm_pool_size=1) as fleet:
        wait_for(lambda: fleet.warm_pool.ready_names(), "the warm worker")
        warm = fleet.warm_pool.ready_names()[0]
        assert fleet._kv.get(f"/serving/warm/{warm}") == "1"
        assert_same(port_results(fleet, traffic), want)
        assert f"up:{warm}" in fleet.autoscaler.actions
        wait_for(lambda: len(fleet.workers) == 2, "the claimed worker",
                 step=fleet._attach_ready)
        fe = fleet.frontend
        assert fe.metrics.counter("pool_attaches_total") == 1
        assert fleet._kv.get(f"/serving/warm/{warm}") is None
        for _ in range(12):                   # idle: drain to min_workers
            fleet.step()
        down = [a for a in fleet.autoscaler.actions if a.startswith("down:")]
        assert down and len(fleet.workers) == 1
        drained = down[0].split(":", 1)[1]
        assert drained not in fleet.workers and drained not in fleet._procs
        assert_same(port_results(fleet, traffic[:2]),
                    {i: want[i] for i in range(2)})


def test_roles_wire_pulls_and_rolling_swap(weights):
    from paddle_tpu.inference.blockwire import \
        BlockWireServer as JWireServer
    from paddle_tpu.inference.kv_fabric import KVFabric as JFabric
    from paddle_tpu.inference.kv_fabric import MemoryKV as JMemoryKV
    from paddle_tpu_torch.inference.fleet import (connect_workers,
                                                  worker_roles, worker_wires)
    from paddle_tpu_torch.inference.kv_fabric import KVFabric, MemoryKV
    from paddle_tpu_torch.inference.serving import prompt_block_hashes

    jax_model = weights["v0"][0]
    bs = ENGINE["block_size"]
    prompt = list(range(2, 26))               # 3 full blocks
    hashes = prompt_block_hashes(prompt, bs)
    with make_fleet(weights, 2, worker_roles=["prefill", "decode"],
                    spec_extra={"wire": True},
                    frontend_kwargs={"kv_fabric": KVFabric(MemoryKV())}
                    ) as fleet:
        ep = fleet.master_endpoint
        assert worker_roles(ep) == {"worker0": "prefill",
                                    "worker1": "decode"}
        reps = {r.engine.worker: r.engine for r in fleet.frontend.replicas}
        pre, dec = reps["worker0"], reps["worker1"]
        assert (pre.role, dec.role) == ("prefill", "decode")
        wires = worker_wires(ep)
        assert (pre.wire_endpoint, dec.wire_endpoint) == (
            wires["worker0"], wires["worker1"])

        # the prompt's KV on the prefill worker, pulled worker to worker
        pre.add_request(prompt, max_new_tokens=1)
        for _ in range(64):
            pre.step()
            if pre.pop_finished():
                break
        payload = pre.export_blocks(hashes)
        assert set(payload["blocks"]) == set(hashes)
        n, nbytes = dec.pull_blocks(wires["worker0"], hashes)
        assert n == len(hashes) and nbytes > 0
        assert dec.import_blocks(payload) == 0     # first publisher wins
        back = dec.export_blocks(hashes)
        for h in hashes:
            for side in ("k", "v"):
                for a, b in zip(payload["blocks"][h][side],
                                back["blocks"][h][side]):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))

        # a port worker pulls off a JAX engine's listener, bit for bit
        jeng = JEngine(jax_model, **ENGINE)
        other = list(range(30, 54))
        jeng.add_request(other, max_new_tokens=1)
        jeng.run()
        ohash = prompt_block_hashes(other, bs)
        jpay = jeng.export_blocks(ohash)
        with JWireServer(jeng) as jsrv:
            n, _ = dec.pull_blocks(jsrv.endpoint, ohash)
        assert n == len(ohash)
        got = dec.export_blocks(ohash)
        for h in ohash:
            for side in ("k", "v"):
                for a, b in zip(jpay["blocks"][h][side],
                                got["blocks"][h][side]):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))

        # the takeover path rebuilds a role-correct fleet
        assert {r.worker: r.role for r in connect_workers(ep)} == {
            "worker0": "prefill", "worker1": "decode"}

        # disaggregated serving: every chain over the wire, JAX's tokens
        traffic = [(list(range(60, 60 + 9 + 4 * i)), 5, "NORMAL", {})
                   for i in range(4)]
        jpre, jdec = JEngine(jax_model, **ENGINE), JEngine(jax_model,
                                                           **ENGINE)
        jpre.role, jdec.role = "prefill", "decode"
        with JWireServer(jpre), JWireServer(jdec):
            jfe = JFrontend([jpre, jdec], kv_fabric=JFabric(JMemoryKV()))
            jr = [jfe.submit(p, max_new_tokens=n) for p, n, _, _ in traffic]
            want = outcome(jfe.run(), jr)
        assert_same(port_results(fleet, traffic), want)
        fab = fleet.frontend.fabric.counters
        assert fab["wire_pulls_total"] > 0
        assert fab["relay_pulls_total"] == 0
        assert fab["wire_fallbacks_total"] == 0

        # a rolling swap to v2's weights: v2's JAX tokens after it
        assert fleet.rolling_swap(spec(weights, "v2"), "v2") == 2
        assert {r.engine.weights_version
                for r in fleet.frontend.replicas} == {"v2"}
        jpre2, jdec2 = (JEngine(weights["v2"][0], **ENGINE)
                        for _ in range(2))
        jpre2.role, jdec2.role = "prefill", "decode"
        with JWireServer(jpre2), JWireServer(jdec2):
            jfe = JFrontend([jpre2, jdec2], kv_fabric=JFabric(JMemoryKV()))
            jr = [jfe.submit(p, max_new_tokens=n) for p, n, _, _ in traffic]
            want2 = outcome(jfe.run(), jr)
        assert want2 != want
        assert_same(port_results(fleet, traffic), want2)
        assert fleet.worker_spec["numpy_state"] == weights["v2"][1]


def test_default_workers_need_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("the refusal is only observable without CUDA")
    rpc.shutdown()
    with ServingFleet(spec(weights), num_workers=0,
                      spawn_timeout=DEADLINE) as fleet:
        assert not fleet.cpu_workers
        with pytest.raises(RuntimeError) as e:
            fleet.spawn_worker()
        assert "no CUDA device is available" in str(e.value)
        (err,) = fleet.spawn_errors.values()
        assert "no CUDA device is available" in err
        assert fleet.frontend is None and fleet.workers == []
