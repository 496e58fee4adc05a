#!/usr/bin/env python
"""Chaos soaks for the serving fleet across worker processes: a SEEDED
fault schedule over real ``serving_worker`` processes behind the port's
frontend, asserting the fault-containment contract end to end.

Copied from the fleet-facing part of ``tools/chaos_serving.py`` of the JAX
package (the shared helpers, ``run_chaos_fleet`` and ``run_standby_fleet``
with its child half ``standby_serve_phase``); the in-process modes are not
ported.  Adapted to the port: the workers and the soak's own reference
engines run on ``--device`` (``cuda`` unless ``--device cpu`` is given),
and ``--numpy-state`` loads a ``.npz`` of the JAX package's
``state_dict`` over the seeded weights (workers and reference alike), so
the soak can run on the JAX package's weights.  Each report also carries
its survivors' tokens (``survivors``: stream index -> tokens), so a caller
can hold them against another reference.

``--workers N`` runs N real worker processes with worker-side failpoints
armed through the spec JSON (``engine.step`` / ``engine.megastep``
delays, a ``health.probe`` fault on worker0) plus a frontend-side
``rpc.send`` timeout, and asserts:

* every submitted request reaches a terminal typed status — no hangs,
  no silent drops;
* every COMPLETED request's tokens are identical to a fault-free run of
  the same request stream on in-process engines;
* at least one worker death was observed and survived.

``--standby --workers N`` runs the HA phase: worker processes that
OUTLIVE a real active-frontend child, which the parent SIGKILLs (default)
or SIGSTOPs/SIGCONTs (``--zombie``, a true paused-through-expiry zombie).
The parent becomes the standby, takes over at epoch 2 when the lease
expires, replays the client and asserts the split-brain contract: every
journaled admit reaches exactly one typed terminal, every client retry
returns its original rid, a resumed zombie's RPCs land typed
``StaleEpoch`` with zero duplicate token execution, and COMPLETED
survivors equal a crash-free same-seed run.

One JSON report on stdout:

    python -m paddle_tpu_torch.tools.chaos_serving --workers 3 --requests 8
    python -m paddle_tpu_torch.tools.chaos_serving --standby --workers 2 \\
        --zombie --device cpu

Every spawn and wait carries its own deadline (60 s).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# sub-tiny config (same scale the serving control-plane tests use): the
# soak steps its replicas hundreds of times.  megastep_k=2 (not the engine
# default 8): the soak's faults are scheduled in STEP counts, and K=8
# retires these 3-7 token requests in one boundary.  K=2 still drives the
# engine.megastep site + batched-RPC path every decode while keeping
# enough boundaries for the schedule to interleave.
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160,
             num_hidden_layers=1, num_attention_heads=2,
             max_position_embeddings=256)
ENGINE = dict(max_batch_size=2, max_seq_len=64, block_size=8,
              token_budget=16, megastep_k=2)
POISON_PROMPT = [66, 6, 6]   # signature "p66-6-6-" for the poison match
SEED = 11                    # the weights' seed, workers and reference
DEADLINE_S = 60.0            # every spawn and wait of a soak


def _build_model(numpy_state=None, device=None):
    """The soak's model (``MODEL``, seed ``SEED``) on ``device`` (None:
    cuda); ``numpy_state`` loads the JAX package's weights over it."""
    from paddle_tpu_torch.inference.fleet import build_spec_model

    return build_spec_model(MODEL, SEED, device=device,
                            numpy_state=numpy_state)


def _spec(numpy_state=None, **extra):
    """The worker spec of the soak's model and engine."""
    spec = {"seed": SEED, "model": MODEL, "engine": ENGINE, **extra}
    if numpy_state:
        spec["numpy_state"] = os.path.abspath(numpy_state)
    return spec


def _reference_tokens(model, reqs, replicas=1):
    """Fault/crash-free same-seed reference: {stream index: tokens} for
    the shared seeded request stream, served by fresh engines (on the
    model's device) with no injector.  The ONE definition every soak
    compares its survivors against (stream tuples may carry a
    sampling-kwargs dict as their optional 4th element)."""
    from paddle_tpu_torch.inference import ServingEngine, ServingFrontend

    fe = ServingFrontend([ServingEngine(model, device=model.device,
                                        **ENGINE)
                          for _ in range(replicas)])
    rids = [fe.submit(p, max_new_tokens=m, priority=pr,
                      **(rest[0] if rest else {}))
            for p, m, pr, *rest in reqs]
    res = fe.run()
    return {i: res[r].tokens for i, r in enumerate(rids)}


def _request_stream(seed, num_requests, poison):
    """Seeded (prompt, max_new_tokens, priority) stream shared by the
    fault-free reference and the chaos run."""
    import random

    from paddle_tpu_torch.inference import Priority

    rng = random.Random(f"chaos-reqs:{seed}")
    reqs = []
    for i in range(num_requests):
        prompt = [rng.randrange(1, MODEL["vocab_size"])
                  for _ in range(rng.randrange(2, 6))]
        prio = (Priority.HIGH if i % 5 == 0
                else Priority.LOW if i % 5 == 4 else Priority.NORMAL)
        reqs.append((prompt, rng.randrange(3, 7), prio))
    if poison:
        # poison rides mid-stream at NORMAL priority so it reaches several
        # replicas before quarantine while other traffic is in flight
        reqs.insert(num_requests // 3,
                    (list(POISON_PROMPT), 4, Priority.NORMAL))
    return reqs


def _fault_schedule(seed, total_names, poison):
    """Seeded failpoint schedule of the in-process soak: each initial
    replica gets one scheduled step fault (error/timeout/drop round-robin
    so >= 3 kinds fire), a delay rides the first replica's add_request
    path, and some respawn names are doomed too (that is what drives the
    breaker).  The ``engine.megastep`` site is always armed: one scheduled
    crash fires at a megastep launch, mid-batched-decode."""
    import random

    rng = random.Random(f"chaos-sched:{seed}")
    kinds = ["error", "timeout", "drop"]
    sites = {}
    for i in range(total_names):
        doomed = i < 3 or rng.random() < 0.35
        if doomed:
            sites[f"r{i}.step"] = {
                "kind": kinds[i % 3] if i < 3 else kinds[rng.randrange(3)],
                "after": rng.randrange(2, 9),
                "times": 1,
            }
    sites["r0.add_request"] = {"kind": "delay", "delay_s": 0.001, "times": 2}
    sites["engine.megastep"] = {"kind": kinds[rng.randrange(3)],
                                "after": rng.randrange(1, 5), "times": 1}
    # mixed-phase megastep: a crash at a prompt-chunk feed boundary —
    # mid-prefill, before the row's first token — must fail over with
    # full replay equality like any other death
    sites["engine.prefill_chunk"] = {"kind": kinds[rng.randrange(3)],
                                     "after": rng.randrange(1, 6),
                                     "times": 1}
    if poison:
        sites["engine.step"] = {"kind": "error", "match": "p66-6-6-"}
    return sites


def _kill_request_stream(seed, num_requests):
    """The shared seeded stream with per-request sampling attached:
    every third request is a seeded NON-GREEDY stream, so recovery has
    to prove the (seed, sample-index) replay contract, not just greedy
    determinism.  Wraps ``_request_stream`` (one generator for both
    soaks); attaching sampling consumes no rng draws, so the
    prompt/priority cadence is identical."""
    return [(p, m, pr,
             {"temperature": 0.8, "top_k": 16, "top_p": 0.95,
              "seed": 1000 + i} if i % 3 == 1 else {})
            for i, (p, m, pr)
            in enumerate(_request_stream(seed, num_requests, poison=False))]


def run_chaos_fleet(seed=0, workers=3, num_requests=8, max_steps=3000,
                    device=None, numpy_state=None):
    """Fleet-level chaos: real worker processes on ``device`` (None:
    cuda), worker-side failpoints armed through the spec JSON,
    frontend-side rpc fault, heartbeat failover — the cross-process half
    of the containment contract."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.inference import (FaultInjector, RequestStatus,
                                            ServingFleet)

    dev = resolve_device(device)
    model = _build_model(numpy_state, dev)
    reqs = _request_stream(seed, num_requests, poison=False)
    ref_tokens = _reference_tokens(model, reqs)

    spec = _spec(numpy_state, faults={"seed": seed, "sites": {
        # worker-side failpoints travel in the replica recipe: a harmless
        # engine-step delay on every worker, plus worker0's health probe
        # blowing up (the heartbeat-failover kind).  Every worker runs the
        # same spec, so the probe fault is name-matched to worker0 only;
        # times=2 outlasts the heartbeat's one transient retry (after=1
        # spares the RemoteReplica.__init__ readiness probe)
        "engine.step": {"kind": "delay", "delay_s": 0.002, "times": 3},
        # the batched-decode failpoint: a couple of delays at megastep
        # launch prove the one-RPC-per-K-tokens path is traversed and
        # survivable in real worker processes
        "engine.megastep": {"kind": "delay", "delay_s": 0.002, "times": 2},
        "health.probe": {"kind": "error", "match": "worker0",
                         "after": 1, "times": 2},
    }})
    # frontend-side transport fault: exactly one step RPC times out
    rpc.set_fault_injector(FaultInjector(
        {"rpc.send": {"kind": "timeout", "match": "_w_step",
                      "after": 4, "times": 1}}, seed=seed))
    try:
        with ServingFleet(spec, num_workers=workers,
                          heartbeat_interval_s=0.5,
                          spawn_timeout=DEADLINE_S,
                          cpu_workers=dev.type == "cpu") as fleet:
            fe = fleet.frontend
            rids = [fe.submit(p, max_new_tokens=m, priority=pr)
                    for p, m, pr in reqs]
            steps = 0
            while fe.pending and steps < max_steps:
                fleet.step()
                steps += 1
            res = fe.results()
            assert not fe.pending, (
                f"fleet chaos stalled with {fe.pending} unresolved")
            statuses = {}
            mismatched = []
            survivors = {}
            for i, rid in enumerate(rids):
                r = res[rid]
                statuses[r.status.value] = statuses.get(r.status.value, 0) + 1
                if r.status is RequestStatus.COMPLETED:
                    survivors[i] = list(r.tokens)
                    if r.tokens != ref_tokens[i]:
                        mismatched.append(rid)
            assert not mismatched, (
                f"fleet survivors diverged from fault-free run: {mismatched}")
            m = fe.metrics
            deaths = m.counter("replica_deaths_total")
            # the health.probe fault fires on every worker's FIRST
            # heartbeat-after-one (after=1, per-process counters), and the
            # rpc timeout kills whichever worker the 5th step RPC hits —
            # at least one death must have been observed and survived
            assert deaths >= 1, "no fault reached the fleet layer"
            return {
                "mode": "fleet",
                "seed": seed,
                "workers": workers,
                "device": dev.type,
                "requests": len(rids),
                "steps": steps,
                "statuses": statuses,
                "replica_deaths": deaths,
                "requeued_on_failover":
                    m.counter("requeued_on_failover_total"),
                "workers_alive_at_end": fe.metrics.gauge("replicas_alive"),
                "survivors_token_identical": True,
                "survivors": survivors,
            }
    finally:
        rpc.set_fault_injector(None)


def standby_serve_phase(master_ep, journal_path, seed, num_requests,
                        pause_after, self_kill, max_steps=3000):
    """Child half of ``--standby --workers``: the ACTIVE frontend over
    real workers.  Acquires the lease at epoch 1, serves the seeded
    keyed stream through a journal, and at the pause condition either
    SIGKILLs itself (crash variant) or writes a marker file and keeps
    stepping SLOWLY until the parent SIGSTOPs it (zombie variant).  A
    resumed zombie observes its deposition as a typed ``StaleEpoch``,
    then PROVES the worker fences by issuing one stale-epoch RPC per
    worker, records the outcome in a sidecar, and exits rc=42."""
    import signal
    import time as _time

    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.inference import (RequestJournal, ServingFrontend,
                                            StaleEpoch)
    from paddle_tpu_torch.inference.fleet import connect_workers
    from paddle_tpu_torch.inference.ha import FrontendLease

    rpc.init_rpc("frontend-a", rank=0, world_size=1,
                 master_endpoint=master_ep)
    lease = FrontendLease(master_ep, ttl_s=3.0, holder="frontend-a",
                          seed=seed)
    assert lease.acquire() == 1, "active could not acquire a fresh lease"
    replicas = connect_workers(master_ep)
    assert replicas, "no workers discovered"
    fe = ServingFrontend(replicas,
                         journal=RequestJournal(journal_path, fsync=False),
                         lease=lease)
    reqs = _kill_request_stream(seed, num_requests)
    rids = [fe.submit(p, max_new_tokens=m, priority=pr,
                      idempotency_key=f"req-{i}", **sk)
            for i, (p, m, pr, sk) in enumerate(reqs)]
    client_log = open(journal_path + ".client", "w")
    marker = journal_path + ".paused"
    seen = set()
    signalled = False
    for _ in range(max_steps):
        try:
            fe.step()
        except StaleEpoch:
            # the resumed zombie learns it was deposed (lease renew or a
            # worker fence — whichever it hit first).  Prove the WORKER
            # fence explicitly: a stale-epoch step RPC per worker must
            # land typed StaleEpoch, executing nothing
            worker_fenced = 0
            other = 0
            for rep in replicas:
                # drop any step future issued BEFORE the pause: the
                # proof must be a FRESH stale-epoch RPC, not the
                # collected result of a legitimately pre-takeover step
                rep._pending_step = None
                try:
                    rep.step()
                except StaleEpoch:
                    worker_fenced += 1
                except Exception:  # noqa: BLE001 — e.g. worker gone
                    other += 1
            with open(journal_path + ".zombie", "w") as f:
                json.dump({"deposed_typed": True,
                           "worker_fenced": worker_fenced,
                           "worker_other_errors": other,
                           "terminals_observed": len(seen)}, f)
            sys.exit(42)
        for rid, res in fe.results().items():
            if rid in seen:
                continue
            seen.add(rid)
            client_log.write(json.dumps(
                {"rid": rid, "status": res.status.value,
                 "tokens": res.tokens}) + "\n")
            client_log.flush()
        in_flight = any(r.generated and rid not in seen
                        for rid, r in fe._requests.items())
        if not signalled and len(seen) >= pause_after and in_flight:
            if self_kill:
                os.kill(os.getpid(), signal.SIGKILL)   # never returns
            open(marker, "w").write("ready")
            signalled = True
        if signalled:
            # slow-step so the parent's SIGSTOP lands mid-activity
            _time.sleep(0.05)
        if len(seen) == len(rids):
            break
    # drained before the pause condition (or resumed without being
    # deposed): parameters wrong — exit 0 and let the parent fail on rc
    sys.exit(0)


def run_standby_fleet(seed=0, workers=2, num_requests=10, pause_after=3,
                      zombie=False, max_steps=3000, device=None,
                      numpy_state=None):
    """Parent half of ``--standby --workers``: real worker processes on
    ``device`` (None: cuda) that OUTLIVE the active frontend child, which
    the parent SIGKILLs (crash) or SIGSTOP/SIGCONTs (true zombie).  The
    parent then becomes the standby, waits out the lease TTL, takes over
    at epoch 2, replays the client, and asserts the split-brain contract
    with worker-side counters."""
    import signal
    import subprocess
    import tempfile
    import time as _time

    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.distributed.launch.master import KVClient, KVServer
    from paddle_tpu_torch.inference import RequestStatus
    from paddle_tpu_torch.inference.fleet import connect_workers
    from paddle_tpu_torch.inference.ha import FrontendLease, StandbyFrontend

    dev = resolve_device(device)
    model = _build_model(numpy_state, dev)
    reqs = _kill_request_stream(seed, num_requests)
    # in-process reference engines are token-identical to worker
    # processes — the fleet contract
    ref_tokens = _reference_tokens(model, reqs, replicas=2)

    kvs = KVServer(0).start()
    ep = f"127.0.0.1:{kvs.port}"
    kv = KVClient(ep)
    journal_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_sbyfleet_")
    jpath = os.path.join(journal_dir, "requests.wal")
    spec = _spec(numpy_state)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    if dev.type == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    procs = {}
    child = None
    try:
        # ---- worker processes (they outlive every frontend)
        for i in range(workers):
            name = f"w{i}"
            log = open(os.path.join(journal_dir, f"{name}.log"), "w")
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(here, "serving_worker.py"),
                 "--master", ep, "--name", name,
                 "--spec-json", json.dumps(spec), "--device", dev.type],
                stdout=log, stderr=subprocess.STDOUT, env=env)
            log.close()
        deadline = _time.monotonic() + DEADLINE_S
        for name in procs:
            while kv.get(f"/rpc/workers/{name}") is None:
                assert procs[name].poll() is None, f"worker {name} died"
                assert _time.monotonic() < deadline, "worker boot timeout"
                _time.sleep(0.1)

        # ---- the ACTIVE frontend child
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--standby-serve-phase", "--master", ep, "--journal", jpath,
             "--seed", str(seed), "--requests", str(num_requests),
             "--pause-after", str(pause_after)]
            + ([] if zombie else ["--self-kill"]), env=env)
        if zombie:
            marker = jpath + ".paused"
            deadline = _time.monotonic() + DEADLINE_S
            while not os.path.exists(marker):
                assert child.poll() is None, (
                    f"active child exited rc={child.returncode} before "
                    "the pause condition")
                assert _time.monotonic() < deadline, "pause marker timeout"
                _time.sleep(0.02)
            os.kill(child.pid, signal.SIGSTOP)   # a true zombie
        else:
            child.wait(timeout=DEADLINE_S)
            assert child.returncode == -signal.SIGKILL, (
                f"active child exited rc={child.returncode}, expected "
                "self-SIGKILL — stream drained before the kill condition")

        # ---- the parent becomes the standby
        rpc.init_rpc("standby-frontend", rank=0, world_size=1,
                     master_endpoint=ep)
        lease = FrontendLease(ep, ttl_s=3.0, holder="standby-frontend",
                              seed=seed)
        standby = StandbyFrontend(
            lease, jpath, lambda: connect_workers(ep))
        fe = standby.wait_for_takeover(timeout_s=DEADLINE_S)
        assert fe.epoch == 2, fe.epoch
        assert fe.metrics.counter("standby_takeovers_total") == 1
        assert fe.metrics.counter("failovers_total") == 1
        # the dead child's stale "frontend-a" registration must not have
        # come back as a bogus replica
        names = sorted(getattr(r.engine, "worker", "?")
                       for r in fe.replicas)
        assert names == sorted(procs), names

        def worker_counters(name_):
            out = {}
            for rep in fe.replicas:
                h = rep.engine.health()
                out[h["name"]] = h["metrics"]["counters"].get(name_, 0)
            return out

        tokens_at_takeover = worker_counters("tokens_emitted_total")
        zombie_report = None
        if zombie:
            # resume the zombie AFTER takeover: its epoch-1 RPCs must
            # all land typed StaleEpoch and execute nothing
            os.kill(child.pid, signal.SIGCONT)
            child.wait(timeout=DEADLINE_S)
            assert child.returncode == 42, (
                f"zombie exited rc={child.returncode}, expected the "
                "deposed-typed marker (42)")
            with open(jpath + ".zombie") as f:
                zombie_report = json.load(f)
            assert zombie_report["deposed_typed"]
            assert zombie_report["worker_fenced"] >= 1
            fenced = worker_counters("fenced_rpcs_total")
            assert sum(fenced.values()) >= 1, fenced
            # zero duplicate token execution: the standby has not run
            # yet, so any delta here would be the zombie's
            assert worker_counters("tokens_emitted_total") \
                == tokens_at_takeover

        # ---- client replay + drain on the new incarnation
        retry_rids = [fe.submit(p, max_new_tokens=m, priority=pr,
                                idempotency_key=f"req-{i}", **sk)
                      for i, (p, m, pr, sk) in enumerate(reqs)]
        assert retry_rids == list(range(num_requests)), retry_rids
        assert fe.metrics.counter("idempotent_hits_total") == num_requests
        res = fe.run(max_steps=max_steps)

        pre_client = {}
        if os.path.exists(jpath + ".client"):
            with open(jpath + ".client") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue   # torn final line: the crash's right
                    pre_client[rec["rid"]] = rec
        statuses = {}
        mismatched = []
        survivors = {}
        for i in range(num_requests):
            r = res[i]
            statuses[r.status.value] = statuses.get(r.status.value, 0) + 1
            if r.detail.startswith("recovered terminal"):
                cl = pre_client.get(i)
                if cl is not None and cl["status"] == "completed":
                    survivors[i] = cl["tokens"]
                    if cl["tokens"] != ref_tokens[i]:
                        mismatched.append(i)
            elif r.status is RequestStatus.COMPLETED:
                survivors[i] = list(r.tokens)
                if r.tokens != ref_tokens[i]:
                    mismatched.append(i)
        assert not mismatched, (
            f"survivors diverged from crash-free run: {mismatched}")

        report = {
            "mode": "standby-fleet",
            "variant": "zombie" if zombie else "sigkill",
            "seed": seed,
            "workers": workers,
            "device": dev.type,
            "requests": num_requests,
            "takeover_epoch": fe.epoch,
            "recovered_requests":
                fe.metrics.counter("recovered_requests_total"),
            "idempotent_hits":
                fe.metrics.counter("idempotent_hits_total"),
            "statuses": statuses,
            "worker_fenced_rpcs":
                sum(worker_counters("fenced_rpcs_total").values()),
            "zombie": zombie_report,
            "survivors_token_identical": True,
            "exactly_one_terminal_per_admit": True,
            "survivors": survivors,
        }
        # polite worker shutdown under the CURRENT epoch
        for rep in fe.replicas:
            try:
                rep.engine.request_shutdown(timeout=10)
            except Exception:  # noqa: BLE001
                pass
        return report
    finally:
        if child is not None and child.poll() is None:
            try:
                os.kill(child.pid, signal.SIGCONT)
            except OSError:
                pass
            child.kill()
            child.wait(timeout=10)
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        try:
            rpc.shutdown()
        except Exception:  # noqa: BLE001
            pass
        kvs.stop()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=None,
                    help="request count (default: 8; 10 with --standby)")
    ap.add_argument("--workers", type=int, default=0,
                    help="N>0 worker processes with spec-armed failpoints "
                         "(required: the in-process modes are not ported)")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the workers and the reference engines run "
                         "(default cuda)")
    ap.add_argument("--numpy-state", default=None,
                    help=".npz of the JAX package's state_dict, loaded "
                         "over the seeded weights")
    ap.add_argument("--standby", action="store_true",
                    help="HA phase: lease-based standby failover + zombie "
                         "fencing over real worker processes")
    ap.add_argument("--pause-after", type=int, default=3,
                    help="standby: pause/kill the active frontend once "
                         "this many requests are terminal (with work "
                         "in flight)")
    ap.add_argument("--zombie", action="store_true",
                    help="standby: SIGSTOP/SIGCONT the active frontend "
                         "instead of SIGKILL (a true zombie)")
    ap.add_argument("--journal", default=None,
                    help="journal path (internal: --standby-serve-phase)")
    ap.add_argument("--master", default=None,
                    help="KV master endpoint (internal: "
                         "--standby-serve-phase)")
    ap.add_argument("--self-kill", action="store_true",
                    help="internal: standby serve phase SIGKILLs itself")
    ap.add_argument("--standby-serve-phase", action="store_true",
                    help="internal: the active-frontend child half of "
                         "--standby --workers")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 10 if args.standby else 8
    if args.standby_serve_phase:
        standby_serve_phase(args.master, args.journal, args.seed,
                            args.requests, args.pause_after,
                            args.self_kill)
        return
    if args.workers <= 0:
        ap.error("--workers N (N > 0) is required: only the fleet soaks "
                 "are ported")
    if args.standby:
        report = run_standby_fleet(seed=args.seed, workers=args.workers,
                                   num_requests=args.requests,
                                   pause_after=args.pause_after,
                                   zombie=args.zombie, device=args.device,
                                   numpy_state=args.numpy_state)
    else:
        report = run_chaos_fleet(seed=args.seed, workers=args.workers,
                                 num_requests=args.requests,
                                 device=args.device,
                                 numpy_state=args.numpy_state)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
