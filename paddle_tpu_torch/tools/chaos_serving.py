#!/usr/bin/env python
"""Chaos soaks for the port's serving stack: a SEEDED fault schedule
over in-process replicas or real ``serving_worker`` processes behind the
port's frontend, asserting the fault-containment contract end to end.

Copied from ``tools/chaos_serving.py`` of the JAX package: the shared
helpers, the in-process soaks (``run_chaos``, ``run_chaos_spec``,
``run_chaos_disagg``, ``run_chaos_multitenant``, ``run_kill_frontend``
with its child half ``serve_phase``, ``run_standby``) and the fleet soaks
(``run_chaos_fleet``, ``run_standby_fleet`` with its child half
``standby_serve_phase``).  Adapted to the port: every engine of a soak
(replicas, the soak's own reference engines, a child process's) runs on
``--device`` (``cuda`` unless ``--device cpu`` is given) through the
model's device; ``--numpy-state`` loads a ``.npz`` of the JAX package's
``state_dict`` over the seeded weights (``--numpy-state-v2`` the
multitenant soak's second version, seed 13), so a soak can run on the
JAX package's weights; ``--model-json`` replaces ``MODEL`` (the
``LlamaConfig`` keyword arguments; a larger model on the card), while the
request streams and fault schedules stay those of ``MODEL`` and
``ENGINE``.  Each report also carries its survivors' tokens
(``survivors``: stream index -> tokens), so a caller can hold them
against another reference.

The in-process soaks (default; ``--brownout``, ``--spec``, ``--disagg``,
``--multitenant``, ``--kill-frontend``, ``--standby``) assert, each
against fault-free engines of the same device:

* every submitted request reaches a terminal typed status — no hangs, no
  silent drops;
* every COMPLETED request's tokens are identical to a fault-free run of
  the same stream (greedy and seeded sampled; a brownout-truncated one
  is a prefix of it);
* the faults actually fired (at least three kinds in the default soak; a
  poison request is quarantined after ``max_request_retries`` replica
  deaths);
* the mode's own contract: speculation degrades and never emits a wrong
  token and replays to the same trace digest (``--spec``); the fabric's
  faults degrade to recompute and the wire both fails over and serves
  (``--disagg``); tenants' budgets, a warm attach and a rolling swap to a
  second weights version with one replica pinned by a swap fault
  (``--multitenant``); a real SIGKILL of a journaled frontend child
  (``python -m paddle_tpu_torch.tools.chaos_serving --serve-phase``),
  then ``recover`` and the client replayed with its idempotency keys
  (``--kill-frontend``); a lease takeover with a manufactured zombie
  whose RPCs all land typed ``StaleEpoch`` and a clean ``handoff()``
  (``--standby`` without ``--workers``).

``--workers N`` runs N real worker processes with worker-side failpoints
armed through the spec JSON (``engine.step`` / ``engine.megastep``
delays, a ``health.probe`` fault on worker0) plus a frontend-side
``rpc.send`` timeout: the same terminal-status and token-parity
assertions across process boundaries, and at least one worker death
observed and survived.

``--standby --workers N`` runs the HA phase over worker processes that
OUTLIVE a real active-frontend child, which the parent SIGKILLs (default)
or SIGSTOPs/SIGCONTs (``--zombie``).  The parent becomes the standby,
takes over at epoch 2 when the lease expires, replays the client and
asserts the split-brain contract.

One JSON report on stdout:

    python -m paddle_tpu_torch.tools.chaos_serving --seed 7 --replicas 3 \\
        --device cpu
    python -m paddle_tpu_torch.tools.chaos_serving --spec --device cpu
    python -m paddle_tpu_torch.tools.chaos_serving --workers 3 --requests 8
    python -m paddle_tpu_torch.tools.chaos_serving --standby --workers 2 \\
        --zombie --device cpu

Every spawn and wait of a fleet soak carries its own deadline (60 s).
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
SEED_V2 = 13                 # the multitenant soak's second version
DEADLINE_S = 60.0            # every spawn and wait of a soak


def _build_model(numpy_state=None, device=None, model_kw=None):
    """The soak's model (``MODEL``, or the ``LlamaConfig`` keywords
    ``model_kw``; seed ``SEED``) on ``device`` (None: cuda);
    ``numpy_state`` loads the JAX package's weights over it."""
    from paddle_tpu_torch.inference.fleet import build_spec_model

    return build_spec_model(model_kw or MODEL, SEED, device=device,
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


def _tally(res, rids):
    """{status value: count} over ``rids``."""
    statuses = {}
    for rid in rids:
        s = res[rid].status.value
        statuses[s] = statuses.get(s, 0) + 1
    return statuses


def run_chaos(seed=0, replicas=3, num_requests=18, max_request_retries=2,
              poison=True, brownout=False, max_steps=3000, device=None,
              numpy_state=None, model_kw=None):
    """In-process chaos soak on ``device`` (None: cuda); returns the
    report dict (raises AssertionError on any containment-contract
    violation).  ``survivors`` maps the stream index of every COMPLETED
    request to its tokens (``brownout_truncated``: those a brownout cut
    short, a prefix of the fault-free tokens)."""
    from paddle_tpu_torch.distributed.rpc import RpcTimeout
    from paddle_tpu_torch.inference import (
        BrownoutPolicy,
        FaultInjector,
        RequestStatus,
        RespawnCircuitBreaker,
        ServingEngine,
        ServingFrontend,
    )
    from paddle_tpu_torch.inference.faults import FaultyReplica
    from paddle_tpu_torch.inference.tracing import (FlightRecorder,
                                                    TraceContext, Tracer,
                                                    events_digest,
                                                    tree_complete)

    model = _build_model(numpy_state, device, model_kw)
    dev = model.device
    reqs = _request_stream(seed, num_requests, poison)
    ref_tokens = _reference_tokens(model, reqs)

    # ---- chaos run
    max_respawns = replicas * 3
    total_names = replicas + max_respawns
    # every replica name this soak may ever spawn, registered up front
    # (arm-time validation catches a schedule typo); the registry is
    # run-scoped, so a later soak in this process starts from an empty set
    run_namespaces: set = set()
    inj = FaultInjector(_fault_schedule(seed, total_names, poison),
                        seed=seed,
                        replica_namespaces=[f"r{i}"
                                            for i in range(total_names)],
                        namespace_registry=run_namespaces)
    # engine pool: respawns recycle a dead replica's engine (a restarted
    # worker rebuilds the same engine; recycling skips the recompile)
    spares = []
    step_i = 0

    def tclock():
        # the soak's only clock: STEP counts — every trace timestamp
        # replays bit-identically under the same (seed, config)
        return float(step_i)

    tracer = Tracer(clock=tclock, proc="frontend")
    inj.recorder = tracer.recorder   # fault fires land in the dumps too

    def wrap(engine, name):
        return FaultyReplica(engine, inj, name=name, timeout_exc=RpcTimeout)

    # the chaos engines carry the injector themselves too: the
    # engine.megastep site lives INSIDE ServingEngine.step, which the
    # FaultyReplica proxy cannot see from outside
    fe = ServingFrontend(
        [wrap(ServingEngine(model, fault_injector=inj,
                            trace_recorder=FlightRecorder(clock=tclock,
                                                          proc=f"r{i}"),
                            clock=tclock, device=dev, **ENGINE), f"r{i}")
         for i in range(replicas)],
        max_request_retries=max_request_retries,
        tracer=tracer,
        # sensitive thresholds: the 2-requests-per-step trickle over 3
        # replicas must be able to cross them while replicas are dying
        brownout=BrownoutPolicy(queue_high=2.5, queue_low=0.5,
                                enter_after=2, exit_after=3,
                                normal_max_new_tokens=6)
        if brownout else None)
    breaker = RespawnCircuitBreaker(threshold=3, window_s=40.0,
                                    base_backoff_s=4.0, max_backoff_s=64.0,
                                    jitter=0.25, seed=seed,
                                    clock=lambda: float(step_i))
    breaker.recorder = tracer.recorder
    born_at = {id(rep): 0 for rep in fe.replicas}
    next_name = replicas
    respawns = early_deaths = deaths = 0

    rids = []
    submitted = 0
    while (fe.pending or submitted < len(reqs)) and step_i < max_steps:
        # trickle arrivals: two per control step keeps a queue formed so
        # faults interleave with real routing/admission pressure
        for _ in range(2):
            if submitted < len(reqs):
                p, m, pr = reqs[submitted]
                rids.append(fe.submit(p, max_new_tokens=m, priority=pr))
                submitted += 1
        fe.step()
        step_i += 1
        # maturation mirrors the fleet layer: a replica alive past the
        # early-death window is the spawn SUCCESS that re-closes a
        # half-open breaker
        for rep in fe.replicas:
            if rep.alive and id(rep) in born_at \
                    and step_i - born_at[id(rep)] >= 5:
                born_at.pop(id(rep))
                breaker.record_success()
        # reap + respawn through the breaker (the fleet layer's job,
        # mirrored here for in-process replicas)
        for rep in list(fe.replicas):
            if rep.alive:
                continue
            deaths += 1
            if step_i - born_at.pop(id(rep), 0) < 5:   # early death
                early_deaths += 1
                breaker.record_failure()
            fe.remove_replica(rep)
            spares.append(rep.engine._eng)
        while (fe.num_live_replicas < replicas and spares
               and next_name < total_names and breaker.allow()):
            eng = spares.pop()
            for rid in [r.rid for r in eng._queue] + list(eng._active):
                eng.evict(rid)   # a restarted worker has empty state
            rep = fe.add_replica(wrap(eng, f"r{next_name}"))
            born_at[id(rep)] = step_i
            next_name += 1
            respawns += 1

    # dead-and-never-respawned engines may still hold undrained worker
    # spans (live replicas were drained inside every fe.step())
    for eng in spares:
        tracer.absorb(eng.pop_trace_events())

    # ---- containment contract
    res = fe.results()
    assert len(res) == len(rids) and not fe.pending, (
        f"chaos soak stalled: {fe.pending} request(s) never reached a "
        f"terminal status in {max_steps} steps")
    mismatched = []
    survivors, truncated = {}, []
    for i, rid in enumerate(rids):
        r = res[rid]
        if r.status is RequestStatus.COMPLETED:
            want = ref_tokens[i]
            survivors[i] = list(r.tokens)
            if r.detail.startswith("brownout:"):
                truncated.append(i)
                ok = r.tokens == want[:len(r.tokens)] and r.tokens
            else:
                ok = r.tokens == want
            if not ok:
                mismatched.append(rid)
    assert not mismatched, (
        f"survivors diverged from the fault-free run: rids {mismatched}")
    kinds = inj.kinds_fired()
    assert len(kinds) >= 3, (
        f"chaos schedule degraded to calm: only kinds {kinds} fired")
    poison_status = None
    if poison:
        pi = next(i for i, (p, _, _) in enumerate(reqs)
                  if p == POISON_PROMPT)
        pr = res[rids[pi]]
        poison_status = pr.status.value
        # the poison must never slip through; quarantine is the normal
        # outcome, FAILED the total-outage path (every replica already
        # dead, so the queued poison resolved before it could kill
        # max_request_retries + 1 replicas)
        assert pr.status in (RequestStatus.FAILED_POISON,
                             RequestStatus.FAILED), (
            f"poison request ended {pr.status}")
        if pr.status is RequestStatus.FAILED_POISON:
            assert pr.attempts == max_request_retries + 1

    # ---- span-tree contract: every typed terminal owns a complete,
    # orphan-free tree, and at least one tree crossed frontend -> engine
    fleet_wide = 0
    for rid in rids:
        tree = tracer.tree_for(TraceContext.mint(rid).trace_id)
        ok, why = tree_complete(tree)
        assert ok, f"rid {rid} span tree incomplete: {why}"
        tree_procs = {e["proc"] for evs in tree.values() for e in evs}
        if len(tree_procs) > 1:
            fleet_wide += 1
    assert fleet_wide >= 1, "no span tree crossed frontend -> engine"

    m = fe.metrics
    return {
        "mode": "in-process",
        "seed": seed,
        "replicas": replicas,
        "device": dev.type,
        "requests": len(rids),
        "steps": step_i,
        "statuses": _tally(res, rids),
        "poison_status": poison_status,
        "fault_kinds_fired": kinds,
        "faults_fired": inj.total_fires,
        "replica_deaths": m.counter("replica_deaths_total"),
        "requeued_on_failover": m.counter("requeued_on_failover_total"),
        "retried": m.counter("requests_retried_total"),
        "quarantined": m.counter("requests_quarantined_total"),
        "respawns": respawns,
        "early_deaths": early_deaths,
        "breaker_opens": breaker.open_count,
        "brownout_transitions": m.counter("brownout_transitions_total"),
        "shed_brownout": m.counter("shed_brownout_total"),
        "survivors_token_identical": True,
        # counter-clocked timestamps; the digest excludes t/seq: the
        # same-seed report equality covers tracing too
        "trace_events": len(tracer.all_events()),
        "trace_trees_complete": len(rids),
        "trace_fleet_wide": fleet_wide,
        "trace_captures": len(tracer.captures),
        "trace_digest": events_digest(tracer.all_events()),
        "survivors": survivors,
        "brownout_truncated": truncated,
    }


def _spec_request_stream(seed, num_requests):
    """Seeded stream for the speculative-decoding soak: REPETITIVE
    prompts (short cyclic patterns — the n-gram drafter's showcase) with
    LONG generations so the greedy streams have room to fall into
    cycles, plus a seeded-sampling minority (4th tuple element) so the
    soak covers the sampled verify path too."""
    import random

    from paddle_tpu_torch.inference import Priority

    rng = random.Random(f"spec-reqs:{seed}")
    patterns = [[1, 2, 3], [10, 20, 30], [9, 4], [5, 6, 7]]
    reqs = []
    for i in range(num_requests):
        prompt = (rng.choice(patterns) * 8)[:8]
        m = rng.randrange(24, 41)
        prio = Priority.HIGH if i % 5 == 0 else Priority.NORMAL
        if i % 4 == 3:
            reqs.append((prompt, m, prio,
                         dict(temperature=0.8, top_k=40, top_p=0.95,
                              seed=100 + i)))
        else:
            reqs.append((prompt, m, prio))
    return reqs


def run_chaos_spec(seed=0, num_requests=12, max_steps=3000, device=None,
                   numpy_state=None, model_kw=None):
    """Speculative-decoding chaos soak: two spec-armed replicas
    (``spec_k`` 4) serve the repetitive stream with BOTH spec failpoints
    firing mid-run — ``engine.spec_draft`` (a drafter fault degrades that
    row to an empty draft) and ``engine.spec_verify`` (a verify-launch
    fault degrades the whole step to the megastep path).  The contract: a
    spec fault NEVER yields a wrong token — every completed request is
    token-identical to fault-free spec-OFF serving (greedy AND seeded) —
    speculation genuinely ran (accepted tokens > 0, ``spec_verify`` span
    events recorded), and the soak is replay-equal: the same seed is run
    TWICE and the trace digests must match bit-for-bit."""
    from paddle_tpu_torch.inference import (FaultInjector, RequestStatus,
                                            ServingEngine, ServingFrontend)
    from paddle_tpu_torch.inference.tracing import (FlightRecorder,
                                                    TraceContext, Tracer,
                                                    events_digest,
                                                    tree_complete)

    model = _build_model(numpy_state, device, model_kw)
    dev = model.device
    reqs = _spec_request_stream(seed, num_requests)
    ref_tokens = _reference_tokens(model, reqs, replicas=2)
    spec_engine = {**ENGINE, "spec_k": 4}

    def once():
        step_i = 0

        def tclock():
            return float(step_i)

        inj = FaultInjector({
            "engine.spec_draft": {"kind": "error", "after": 2,
                                  "times": 2},
            "engine.spec_verify": {"kind": "error", "after": 1,
                                   "times": 2},
        }, seed=seed)
        tracer = Tracer(clock=tclock, proc="frontend")
        inj.recorder = tracer.recorder
        fe = ServingFrontend(
            [ServingEngine(model, fault_injector=inj,
                           trace_recorder=FlightRecorder(clock=tclock,
                                                         proc=f"r{i}"),
                           clock=tclock, device=dev, **spec_engine)
             for i in range(2)],
            tracer=tracer)
        rids = []
        submitted = 0
        while (fe.pending or submitted < len(reqs)) and step_i < max_steps:
            for _ in range(2):
                if submitted < len(reqs):
                    p, m, pr, *rest = reqs[submitted]
                    rids.append(fe.submit(p, max_new_tokens=m,
                                          priority=pr,
                                          **(rest[0] if rest else {})))
                    submitted += 1
            fe.step()
            step_i += 1
        return fe, inj, tracer, rids, step_i

    fe, inj, tracer, rids, steps = once()

    # ---- degrade contract: faults never produce a wrong token
    res = fe.results()
    assert len(res) == len(rids) and not fe.pending, (
        f"spec soak stalled: {fe.pending} request(s) never reached a "
        f"terminal status in {max_steps} steps")
    mismatched = []
    survivors = {}
    for i, rid in enumerate(rids):
        r = res[rid]
        assert r.status is RequestStatus.COMPLETED, (
            f"rid {rid} ended {r.status} — a spec fault must degrade, "
            "never fail the request")
        survivors[i] = list(r.tokens)
        if r.tokens != ref_tokens[i]:
            mismatched.append(rid)
    assert not mismatched, (
        f"spec survivors diverged from fault-free spec-off serving: "
        f"rids {mismatched}")
    for site in ("engine.spec_draft", "engine.spec_verify"):
        assert inj.fires(site) >= 1, f"failpoint {site} never fired"

    # ---- speculation genuinely ran
    m = fe.metrics
    accepted = m.counter("accepted_tokens_total")
    verify_fwds = m.counter("spec_verify_forwards_total")
    assert verify_fwds >= 1, "no verify launch ever ran"
    assert accepted >= 1, "nothing accepted on the repetitive stream"
    spec_events = [e for e in tracer.all_events()
                   if e.get("event") == "spec_verify"]
    assert spec_events, "no spec_verify span event was recorded"

    # ---- span-tree completeness rides along
    for rid in rids:
        tree = tracer.tree_for(TraceContext.mint(rid).trace_id)
        ok, why = tree_complete(tree)
        assert ok, f"rid {rid} span tree incomplete: {why}"

    # ---- replay equality: the whole soak again under the same seed
    digest = events_digest(tracer.all_events())
    _, _, tracer2, _, _ = once()
    digest2 = events_digest(tracer2.all_events())
    assert digest == digest2, (
        "same-seed replay produced a different trace digest — the spec "
        "path leaked nondeterminism")

    return {
        "mode": "spec",
        "seed": seed,
        "device": dev.type,
        "requests": len(rids),
        "steps": steps,
        "statuses": _tally(res, rids),
        "fault_kinds_fired": inj.kinds_fired(),
        "spec_fires": {s: inj.fires(s) for s in
                       ("engine.spec_draft", "engine.spec_verify")},
        "accepted_tokens": accepted,
        "draft_tokens": m.counter("spec_draft_tokens_total"),
        "verify_forwards": verify_fwds,
        "spec_verify_span_events": len(spec_events),
        "survivors_token_identical": True,
        "replay_digest_equal": True,
        "trace_events": len(tracer.all_events()),
        "trace_digest": digest,
        "survivors": survivors,
    }


def _disagg_request_stream(seed, num_requests):
    """Seeded stream for the disaggregation soak: LONG prompts (the
    fabric only moves FULL blocks) with identical-prompt pairs riding
    along to drive the prefill-in-progress dedup table.  Priorities /
    max-new reuse the base stream's seeded cadence."""
    import random

    base = _request_stream(seed, num_requests, poison=False)
    rng = random.Random(f"disagg-reqs:{seed}")
    out = []
    for _, m, pr in base:
        prompt = [rng.randrange(1, MODEL["vocab_size"])
                  for _ in range(rng.randrange(17, 30))]
        out.append((prompt, m, pr))
    for i in range(0, len(out) - 1, 4):
        # the twin keeps its own max_new/priority — only the PROMPT (and
        # so the block chain + prefill claim key) is shared
        out[i + 1] = (list(out[i][0]), out[i + 1][1], out[i + 1][2])
    return out


def run_chaos_disagg(seed=0, num_requests=16, max_steps=3000, device=None,
                     numpy_state=None, model_kw=None):
    """Disaggregated-serving chaos soak: a prefill-role replica + two
    decode replicas over a fenced KV fabric, with the ``fabric.publish``,
    ``fabric.pull`` and ``fabric.directory`` failpoints armed, a
    pre-seeded STALE directory entry (written at epoch 1, frontend fenced
    at 2), and the prefill replica dying mid-run.  The prefill replica
    also serves a real blockwire listener with ``fabric.wire`` armed: the
    first direct pull's handshake errors server-side and degrades to the
    frontend relay, later pulls ride the wire.  Asserts: every request
    reaches a typed terminal, every COMPLETED request is token-identical
    to colocated fault-free serving (greedy AND the dedup twins), every
    fabric fault degraded to recompute, and the prefill / pull / dedup
    machinery actually ran."""
    from paddle_tpu_torch.distributed.rpc import RpcTimeout
    from paddle_tpu_torch.inference import (FaultInjector, RequestStatus,
                                            ServingEngine, ServingFrontend)
    from paddle_tpu_torch.inference.blockwire import BlockWireServer
    from paddle_tpu_torch.inference.faults import FaultyReplica
    from paddle_tpu_torch.inference.kv_fabric import KVFabric, MemoryKV
    from paddle_tpu_torch.inference.serving import prompt_block_hashes
    from paddle_tpu_torch.inference.tracing import (FlightRecorder,
                                                    TraceContext, Tracer,
                                                    events_digest,
                                                    tree_complete)

    model = _build_model(numpy_state, device, model_kw)
    dev = model.device
    reqs = _disagg_request_stream(seed, num_requests)
    ref_tokens = _reference_tokens(model, reqs)

    step_i = 0

    def tclock():
        return float(step_i)

    # all fabric sites armed, and r0.step kills the prefill replica
    # itself mid-soak (the process-death variant); every one must degrade
    # to recompute with token parity intact
    inj = FaultInjector({
        "fabric.publish": {"kind": "error", "after": 1, "times": 1},
        "fabric.pull": {"kind": "error", "after": 1, "times": 1},
        "fabric.directory": {"kind": "error", "after": 4, "times": 1},
        "fabric.wire": {"kind": "error", "times": 1},
        "r0.step": {"kind": "error", "after": 8, "times": 1},
    }, seed=seed, replica_namespaces=["r0", "r1", "r2"])
    tracer = Tracer(clock=tclock, proc="frontend")
    inj.recorder = tracer.recorder

    kv = MemoryKV()
    # the stale lease, planted by a PREVIOUS incarnation (epoch 1, owner
    # long gone) over the first request's real chain: the epoch-2
    # frontend's first lookup must reject it typed and recompute
    KVFabric(kv).publish_chain(
        "ghost-prefill", prompt_block_hashes(reqs[0][0],
                                             ENGINE["block_size"]),
        epoch=1)
    fab = KVFabric(kv, fault_injector=inj)

    def mk(i, role):
        eng = ServingEngine(model, fault_injector=inj,
                            trace_recorder=FlightRecorder(clock=tclock,
                                                          proc=f"r{i}"),
                            clock=tclock, device=dev, **ENGINE)
        eng.role = role
        return FaultyReplica(eng, inj, name=f"r{i}",
                             timeout_exc=RpcTimeout)

    r0 = mk(0, "prefill")
    # the data plane under chaos: a real loopback listener on the prefill
    # engine, its handshake fenced by the fabric's epoch fence and
    # carrying the armed fabric.wire failpoint
    wire = BlockWireServer(r0._eng, fence=fab.fence, fault_injector=inj)
    try:
        fe = ServingFrontend(
            [r0, mk(1, "decode"), mk(2, "decode")],
            kv_fabric=fab, epoch=2, tracer=tracer)

        rids = []
        submitted = 0
        while (fe.pending or submitted < len(reqs)) and step_i < max_steps:
            for _ in range(2):
                if submitted < len(reqs):
                    p, m, pr = reqs[submitted]
                    rids.append(fe.submit(p, max_new_tokens=m, priority=pr))
                    submitted += 1
            fe.step()
            step_i += 1
        for rep in list(fe.replicas):
            if not rep.alive:
                fe.remove_replica(rep)
                tracer.absorb(rep.engine._eng.pop_trace_events())
    finally:
        wire.close()

    # ---- disaggregation contract
    res = fe.results()
    assert len(res) == len(rids) and not fe.pending, (
        f"disagg soak stalled: {fe.pending} request(s) never reached a "
        f"terminal status in {max_steps} steps")
    mismatched = []
    survivors = {}
    for i, rid in enumerate(rids):
        r = res[rid]
        if r.status is RequestStatus.COMPLETED:
            survivors[i] = list(r.tokens)
            if r.tokens != ref_tokens[i]:
                mismatched.append(rid)
    assert not mismatched, (
        f"disagg survivors diverged from colocated serving: {mismatched}")
    for site in ("fabric.publish", "fabric.pull", "fabric.directory",
                 "fabric.wire"):
        assert inj.fires(site) >= 1, f"failpoint {site} never fired"
    # the wire both failed AND served under the same soak
    assert fab.counters["wire_fallbacks_total"] >= 1, (
        "the fabric.wire fault never degraded a pull to the relay")
    assert fab.counters["wire_pulls_total"] >= 1, (
        "no pull ever rode the binary data plane")
    assert fab.counters["wire_bytes_total"] >= 1
    m = fe.metrics
    assert m.counter("fabric_prefill_passes_total") >= 1, (
        "no prefill pass ever ran — the fleet degraded to colocated")
    assert fab.counters["pulls_total"] >= 1, "no chain was ever pulled"
    assert fab.counters["stale_entries_total"] >= 1, (
        "the pre-seeded epoch-1 lease was never rejected")
    assert m.counter("fabric_dedup_waits_total") >= 1, (
        "identical twin prompts never hit the prefill-in-progress table")
    assert m.counter("fabric_recomputes_total") >= 1, (
        "no fabric fault degraded to recompute — the schedule missed")

    # ---- span-tree contract: complete trees, and at least one request
    # carries the prefill -> transfer -> decode hop as a block_transfer
    # event
    transfers = 0
    for rid in rids:
        tree = tracer.tree_for(TraceContext.mint(rid).trace_id)
        ok, why = tree_complete(tree)
        assert ok, f"rid {rid} span tree incomplete: {why}"
        if any(e.get("event") == "block_transfer"
               for evs in tree.values() for e in evs):
            transfers += 1
    assert transfers >= 1, "no block_transfer span event was recorded"

    return {
        "mode": "disagg",
        "seed": seed,
        "device": dev.type,
        "requests": len(rids),
        "steps": step_i,
        "statuses": _tally(res, rids),
        "fault_kinds_fired": inj.kinds_fired(),
        "fabric_fires": {s: inj.fires(s) for s in
                         ("fabric.publish", "fabric.pull",
                          "fabric.directory", "fabric.wire")},
        "wire_pulls": fab.counters["wire_pulls_total"],
        "wire_fallbacks": fab.counters["wire_fallbacks_total"],
        "prefill_passes": m.counter("fabric_prefill_passes_total"),
        "dedup_waits": m.counter("fabric_dedup_waits_total"),
        "recomputes": m.counter("fabric_recomputes_total"),
        "pull_failures": m.counter("fabric_pull_failures_total"),
        "replica_deaths": m.counter("replica_deaths_total"),
        "fabric_counters": dict(fab.counters),
        "requests_with_block_transfer": transfers,
        "survivors_token_identical": True,
        "trace_events": len(tracer.all_events()),
        "trace_digest": events_digest(tracer.all_events()),
        "survivors": survivors,
    }


def _mt_request_stream(seed, num_requests):
    """Seeded (prompt, max_new_tokens, tenant) stream for the
    multi-tenant soak: a STEADY tenant dripping one request per step and
    a BURSTY tenant arriving in bursts.  All NORMAL priority — the soak's
    parity contract is per-weights-version, so nothing may preempt a
    request across versions mid-decode."""
    import random

    rng = random.Random(f"chaos-mt:{seed}")
    reqs = []
    for i in range(num_requests):
        prompt = [rng.randrange(1, MODEL["vocab_size"])
                  for _ in range(rng.randrange(2, 6))]
        tenant = "bursty" if i % 3 == 2 else "steady"
        reqs.append((prompt, rng.randrange(3, 7), tenant))
    return reqs


def run_chaos_multitenant(seed=0, num_requests=18, max_steps=3000,
                          device=None, numpy_state=None,
                          numpy_state_v2=None, model_kw=None):
    """Multi-tenant elastic-platform chaos soak: three replicas + a warm
    pool + a mid-traffic rolling weight swap (v0 -> v2) under a
    bursty-vs-steady tenant mix, with the ``pool.refill``,
    ``pool.attach`` and ``weights.swap`` failpoints armed and fired.
    ``numpy_state`` / ``numpy_state_v2`` load the JAX package's weights of
    each version.  Asserts the platform contract:

    * zero dropped admitted requests — every non-negative rid reaches
      COMPLETED through the warm attach AND the rolling swap;
    * the swap fault leaves exactly one replica on the old version, and
      every COMPLETED request's tokens match the fault-free reference FOR
      ITS OWN ``weights_version``;
    * budget isolation: the bursty tenant takes >= 1 typed OVERLOADED
      budget rejection while the steady tenant completes everything;
    * the warm attach actually served traffic, and per-tenant served
      counters / complete per-request trace trees rode along.

    ``survivors`` maps each admitted stream index to its tokens,
    ``survivor_versions`` to the version that generated them."""
    from paddle_tpu_torch.distributed.rpc import RpcTimeout
    from paddle_tpu_torch.inference import (FaultInjector, Priority,
                                            RequestStatus, ServingEngine,
                                            ServingFrontend, TenantRegistry,
                                            TenantSpec, WarmPool)
    from paddle_tpu_torch.inference.faults import FaultyReplica
    from paddle_tpu_torch.inference.fleet import build_spec_model
    from paddle_tpu_torch.inference.tracing import (FlightRecorder,
                                                    TraceContext, Tracer,
                                                    events_digest,
                                                    tree_complete)

    model_v0 = _build_model(numpy_state, device, model_kw)
    dev = model_v0.device
    # the second version: seed 13, the reference's P.seed(13)
    model_v2 = build_spec_model(model_kw or MODEL, SEED_V2, device=dev,
                                numpy_state=numpy_state_v2)

    reqs = _mt_request_stream(seed, num_requests)
    base = [(p, m, Priority.NORMAL) for p, m, _ in reqs]
    ref_v0 = _reference_tokens(model_v0, base)
    ref_v2 = _reference_tokens(model_v2, base)

    step_i = 0

    def tclock():
        return float(step_i)

    inj = FaultInjector({
        "pool.refill": {"kind": "error", "times": 1},
        "pool.attach": {"kind": "error", "times": 1},
        "weights.swap": {"kind": "error", "times": 1},
    }, seed=seed, replica_namespaces=["r0", "r1", "r2", "r3"])
    tracer = Tracer(clock=tclock, proc="frontend")
    inj.recorder = tracer.recorder

    def mk(i, model):
        eng = ServingEngine(model, fault_injector=inj,
                            trace_recorder=FlightRecorder(clock=tclock,
                                                          proc=f"r{i}"),
                            clock=tclock, device=dev, **ENGINE)
        return FaultyReplica(eng, inj, name=f"r{i}",
                             timeout_exc=RpcTimeout)

    # bursty budget 12: a 3-request burst (each 5-11 tokens) always
    # admits its first and always rejects its third while the first two
    # are still outstanding
    reg = TenantRegistry([TenantSpec("steady"),
                          TenantSpec("bursty", token_budget=12)])
    fe = ServingFrontend([mk(0, model_v0), mk(1, model_v0),
                          mk(2, model_v0)],
                         tenants=reg, tracer=tracer)

    # warm pool with an in-process spawn: builds the engine AND pre-pays
    # its compile with the same throwaway sub-block request a real
    # ``--warm`` worker drives (nothing lands in the prefix cache)
    def spawn_warm(name):
        rep = mk(3, model_v0)
        rep._eng.add_request([1], max_new_tokens=2)
        while rep._eng.num_active or rep._eng._queue:
            rep._eng.step()
        rep._eng.pop_finished()
        rep._eng.pop_trace_events()   # discard the warm-up's spans
        return rep

    pool = WarmPool(1, spawn_warm, fault_injector=inj, metrics=fe.metrics)

    # submission plan: steady drips one per step, bursty arrives in
    # bursts of three.  The tail of BOTH tenants is held back until the
    # rolling swap returns, so that v2 provably serves
    steady = [i for i, r in enumerate(reqs) if r[2] == "steady"]
    bursty = [i for i, r in enumerate(reqs) if r[2] == "bursty"]
    pre_steady, post_steady = steady[:-3], steady[-3:]
    pre_bursty, post_bursty = bursty[:3], bursty[3:]
    plan = {}
    for k, i in enumerate(pre_steady):
        plan.setdefault(k, []).append(i)
    for i in pre_bursty:
        plan.setdefault(4, []).append(i)
    warm_step, swap_step = 6, 9
    total = len(reqs)

    rids = {}
    rejected_budget = []
    submitted = 0

    def advance():
        # one soak step: due submissions + a frontend step.  The rolling
        # swap drives THIS, so traffic keeps arriving mid-swap
        nonlocal step_i, submitted
        for i in plan.get(step_i, ()):
            p, m, tenant = reqs[i]
            rid = fe.submit(p, max_new_tokens=m, tenant=tenant)
            rids[i] = rid
            if rid < 0:
                rejected_budget.append(i)
            submitted += 1
        fe.step()
        step_i += 1

    warm_name = None
    swapped = None
    warm_eng = None
    warm_tokens_at_attach = 0
    while (fe.pending or submitted < total) and step_i < max_steps:
        if step_i == warm_step and warm_name is None:
            # warm attach mid-burst: the first refill AND the first claim
            # each eat an armed fault, then succeed
            pool.refill()              # armed pool.refill error fires
            pool.refill()              # retry fills the pool
            assert pool.claim() is None, (
                "armed pool.attach fault did not fire on first claim")
            claimed = pool.claim()     # re-pooled worker, second claim
            assert claimed is not None, "warm pool empty after refill"
            warm_name, warm_rep = claimed
            warm_eng = warm_rep._eng
            warm_tokens_at_attach = warm_eng.megastep_tokens
            fe.add_replica(warm_rep)
        if step_i == swap_step and swapped is None:
            swapped = fe.rolling_swap(model_v2, "v2", step=advance)
            # post-swap tail: the held-back steadies drip onto the
            # mixed-version fleet and the second bursty burst retests
            # the budget on it
            for k, i in enumerate(post_steady):
                plan.setdefault(step_i + k, []).append(i)
            for i in post_bursty:
                plan.setdefault(step_i + 1, []).append(i)
        advance()

    # ---- platform contract
    res = fe.results()
    admitted = [i for i, rid in rids.items() if rid >= 0]
    assert submitted == total and not fe.pending, (
        f"multitenant soak stalled: {fe.pending} request(s) never "
        f"terminal in {max_steps} steps")
    dropped = [i for i in admitted
               if res[rids[i]].status is not RequestStatus.COMPLETED]
    assert not dropped, (
        f"admitted requests dropped through warm attach/rolling swap: "
        f"{dropped}")

    # mixed-version fleet: the armed weights.swap fault pinned exactly
    # one replica to v0; everything else serves v2
    versions = sorted(getattr(r.engine, "weights_version", "?")
                      for r in fe.replicas)
    assert versions.count("v0") == 1 and versions.count("v2") == 3, (
        f"expected exactly one swap-faulted v0 replica, got {versions}")
    assert swapped == 3, f"rolling_swap reported {swapped}, expected 3"

    # single-version token parity: each survivor matches the reference
    # for the version it actually completed on
    mismatched = []
    version_hist = {}
    survivors, survivor_versions = {}, {}
    for i in admitted:
        r = res[rids[i]]
        version_hist[r.weights_version] = \
            version_hist.get(r.weights_version, 0) + 1
        survivors[i] = list(r.tokens)
        survivor_versions[i] = r.weights_version
        ref = ref_v0 if r.weights_version == "v0" else ref_v2
        if r.tokens != ref[i]:
            mismatched.append((i, r.weights_version))
    assert not mismatched, (
        f"survivors diverged from their version's reference: {mismatched}")
    assert len(version_hist) == 2, (
        f"soak never served both weight versions: {version_hist}")

    # budget isolation: bursty took >= 1 typed rejection, steady took none
    assert rejected_budget, "bursty tenant never hit its token budget"
    assert all(reqs[i][2] == "bursty" for i in rejected_budget), (
        "a steady request was budget-rejected — isolation leaked")
    for i in rejected_budget:
        assert res[rids[i]].status is RequestStatus.OVERLOADED
    assert fe.metrics.counter("tenant_rejected_budget_total") \
        == len(rejected_budget)
    snap = reg.snapshot()
    assert snap["steady"]["served"] > 0 and snap["bursty"]["served"] > 0

    # the three lifecycle failpoints all actually fired
    for site in ("pool.refill", "pool.attach", "weights.swap"):
        assert inj.fires(site) >= 1, f"failpoint {site} never fired"
    assert fe.metrics.counter("weight_swap_failures_total") == 1
    assert warm_eng is not None \
        and warm_eng.megastep_tokens > warm_tokens_at_attach, (
            "warm-attached replica never served a token")

    # span-tree contract: every admitted request's tree is orphan-free
    for i in admitted:
        tree = tracer.tree_for(TraceContext.mint(rids[i]).trace_id)
        ok, why = tree_complete(tree)
        assert ok, f"rid {rids[i]} span tree incomplete: {why}"

    return {
        "mode": "multitenant",
        "seed": seed,
        "device": dev.type,
        "requests": total,
        "admitted": len(admitted),
        "rejected_budget": len(rejected_budget),
        "steps": step_i,
        "statuses": _tally(res, rids.values()),
        "replica_versions": versions,
        "result_versions": dict(sorted(version_hist.items())),
        "swapped_replicas": swapped,
        "swap_failures": fe.metrics.counter("weight_swap_failures_total"),
        "warm_attached": warm_name,
        "pool_fires": {s: inj.fires(s) for s in
                       ("pool.refill", "pool.attach", "weights.swap")},
        "pool_counters": {
            "refills": fe.metrics.counter("pool_refills_total"),
            "attaches": fe.metrics.counter("pool_attaches_total"),
            "attach_failures":
                fe.metrics.counter("pool_attach_failures_total"),
        },
        "served_tokens": {t: int(snap[t]["served"])
                          for t in ("steady", "bursty")},
        "fault_kinds_fired": inj.kinds_fired(),
        "survivors_token_identical": True,
        "trace_events": len(tracer.all_events()),
        "trace_digest": events_digest(tracer.all_events()),
        "survivors": survivors,
        "survivor_versions": survivor_versions,
    }


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


def serve_phase(journal_path, seed, num_requests, kill_after,
                max_steps=3000, device=None, numpy_state=None,
                model_kw=None):
    """Child half of ``--kill-frontend``: a journal-armed frontend over two
    engines on ``device`` serving the seeded stream, SIGKILLing ITSELF
    once >= ``kill_after`` requests are terminal with work still in
    flight.  Self-SIGKILL keeps the crash point deterministic in STEP
    counts while still being a true SIGKILL — nothing flushes, nothing
    runs atexit.  Each terminal result the "client" observed is appended
    (flushed) to ``journal_path + '.client'`` so the parent can check
    pre-crash completions' tokens too."""
    import signal

    from paddle_tpu_torch.inference import (RequestJournal, ServingEngine,
                                            ServingFrontend)

    model = _build_model(numpy_state, device, model_kw)
    reqs = _kill_request_stream(seed, num_requests)
    # fsync=False: the failure model here is process death (SIGKILL),
    # which the OS page cache survives
    fe = ServingFrontend(
        [ServingEngine(model, device=model.device, **ENGINE)
         for _ in range(2)],
        journal=RequestJournal(journal_path, fsync=False))
    rids = [fe.submit(p, max_new_tokens=m, priority=pr,
                      idempotency_key=f"req-{i}", **sk)
            for i, (p, m, pr, sk) in enumerate(reqs)]
    client_log = open(journal_path + ".client", "w")
    seen = set()
    for _ in range(max_steps):
        fe.step()
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
        if len(seen) >= kill_after and in_flight:
            os.kill(os.getpid(), signal.SIGKILL)   # never returns
        if len(seen) == len(rids):
            break
    # the stream drained before the kill condition ever held — the soak
    # parameters are wrong; exit 0 and let the parent fail on the rc
    sys.exit(0)


def run_kill_frontend(seed=0, num_requests=16, kill_after=5,
                      max_steps=3000, journal_dir=None, device=None,
                      numpy_state=None, model_kw=None):
    """Parent half of ``--kill-frontend``: the child (``python -m
    paddle_tpu_torch.tools.chaos_serving --serve-phase``, on the same
    device, weights and model) SIGKILLs itself mid-soak; the parent
    replays the journal, recovers onto fresh engines, replays the client
    with the original idempotency keys and asserts the durability
    contract.  Returns the report dict (raises AssertionError on any
    violation); ``survivors``: stream index -> tokens of every COMPLETED
    request, before the crash (as the client saw it) or after."""
    import signal
    import subprocess
    import tempfile

    from paddle_tpu_torch.inference import (
        FaultInjector,
        RequestJournal,
        RequestStatus,
        ServingEngine,
        ServingFrontend,
    )

    model = _build_model(numpy_state, device, model_kw)
    dev = model.device
    reqs = _kill_request_stream(seed, num_requests)
    ref_tokens = _reference_tokens(model, reqs, replicas=2)

    # ---- serve phase in a child process, SIGKILLed mid-soak
    journal_dir = journal_dir or tempfile.mkdtemp(
        prefix="paddle_tpu_torch_kill_")
    jpath = os.path.join(journal_dir, "requests.wal")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if dev.type == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.chaos_serving",
           "--serve-phase", "--journal", jpath, "--seed", str(seed),
           "--requests", str(num_requests), "--kill-after", str(kill_after),
           "--device", dev.type]
    if numpy_state:
        cmd += ["--numpy-state", os.path.abspath(numpy_state)]
    if model_kw:
        cmd += ["--model-json", json.dumps(model_kw)]
    proc = subprocess.run(cmd, env=env, timeout=600)
    assert proc.returncode == -signal.SIGKILL, (
        f"serve phase exited rc={proc.returncode}, expected SIGKILL "
        f"(-{int(signal.SIGKILL)}) — the stream drained before the kill "
        "condition held; grow --requests or shrink --kill-after")

    # what the client saw before the crash (flushed line-by-line)
    pre_client = {}
    with open(jpath + ".client") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue       # torn final line: the crash's prerogative
            pre_client[rec["rid"]] = rec

    # journal replay BEFORE recover (recover compacts the file)
    snapshot, records = RequestJournal(jpath).replay()
    assert snapshot is None, "serve phase should not have compacted yet"
    admits = {r["rid"]: r for r in records if r["t"] == "admit"}
    pre_terminals = {r["rid"]: r for r in records if r["t"] == "terminal"}
    progressed = {r["rid"] for r in records if r["t"] == "progress"}
    assert len(admits) == num_requests, (
        f"only {len(admits)}/{num_requests} admits journaled")
    for i, (p, _, _, _) in enumerate(reqs):
        assert admits[i]["prompt"] == p, f"admit {i} prompt mismatch"
    assert len(pre_terminals) >= kill_after
    assert len(pre_terminals) < num_requests, "nothing was left in flight"
    assert progressed - set(pre_terminals), (
        "no open request had journaled progress — the kill did not land "
        "mid-generation")
    # the client must never have seen a terminal the journal missed
    assert set(pre_client) <= set(pre_terminals), (
        "client observed terminals the journal lost: "
        f"{sorted(set(pre_client) - set(pre_terminals))}")

    # ---- recover + idempotent client replay
    fe = ServingFrontend.recover(
        jpath, [ServingEngine(model, device=dev, **ENGINE)
                for _ in range(2)])
    recovered = fe.metrics.counter("recovered_requests_total")
    assert recovered == num_requests - len(pre_terminals)
    retry_rids = [fe.submit(p, max_new_tokens=m, priority=pr,
                            idempotency_key=f"req-{i}", **sk)
                  for i, (p, m, pr, sk) in enumerate(reqs)]
    assert retry_rids == list(range(num_requests)), (
        f"client retries re-executed instead of deduping: {retry_rids}")
    assert fe.metrics.counter("idempotent_hits_total") == num_requests
    res = fe.run(max_steps=max_steps)

    # ---- durability contract
    statuses = {}
    mismatched = []
    survivors = {}
    for i in range(num_requests):
        r = res[i]
        statuses[r.status.value] = statuses.get(r.status.value, 0) + 1
        if i in pre_terminals:
            # closed before the crash: recovery must NOT have re-executed
            # it, and the client's record must match the journal
            assert r.detail.startswith("recovered terminal"), (
                f"rid {i} was terminal pre-crash but re-executed")
            assert r.status.value == pre_terminals[i]["status"]
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
        f"survivors diverged from the crash-free run: rids {mismatched}")
    sampled_survivors = [i for i in range(num_requests)
                         if i not in pre_terminals and reqs[i][3]
                         and res[i].status is RequestStatus.COMPLETED]

    # ---- journal failpoints degrade, never crash (same model, cheap)
    inj = FaultInjector({"journal.append": {"kind": "error", "after": 2,
                                            "times": 1}}, seed=seed)
    dj = RequestJournal(os.path.join(journal_dir, "degrade.wal"),
                        fsync=False, fault_injector=inj)
    dfe = ServingFrontend([ServingEngine(model, device=dev, **ENGINE)],
                          journal=dj)
    drids = [dfe.submit(p, max_new_tokens=m) for p, m, _, _ in reqs[:4]]
    dres = dfe.run()
    assert all(dres[r].status is RequestStatus.COMPLETED for r in drids)
    assert dfe.journal_degraded
    assert dfe.metrics.gauge("journal_degraded") == 1.0

    return {
        "mode": "kill-frontend",
        "seed": seed,
        "device": dev.type,
        "requests": num_requests,
        "terminal_before_kill": len(pre_terminals),
        "recovered_requests": recovered,
        "orphans_reaped": fe.metrics.counter("orphans_reaped_total"),
        "idempotent_hits": fe.metrics.counter("idempotent_hits_total"),
        "statuses": statuses,
        "sampled_survivors_token_identical": len(sampled_survivors),
        "survivors_token_identical": True,
        "exactly_one_terminal_per_admit": True,
        "journal_fault_degrades_not_crashes": True,
        "fault_kinds_fired": inj.kinds_fired(),
        "survivors": survivors,
    }


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


class _CountingEngine:
    """Thin engine proxy counting ``step`` calls: the in-process proof
    that a fenced zombie RPC never reached the engine (zero duplicate
    token execution — the fence raises BEFORE delegation)."""

    def __init__(self, eng):
        self._eng = eng
        self.step_calls = 0

    def __getattr__(self, attr):
        return getattr(self._eng, attr)

    def step(self):
        self.step_calls += 1
        return self._eng.step()


def run_standby(seed=0, num_requests=14, pause_after=4, max_steps=3000,
                journal_dir=None, device=None, numpy_state=None,
                model_kw=None):
    """In-process HA soak: active + standby incarnations over SHARED
    engines (on ``device``) behind EpochFence/FencedEngine wrappers,
    lease expiry on an injected counter clock (deterministic — no
    wall-clock gates), a manufactured zombie, and the graceful-handoff
    leg.  Returns the report dict; raises AssertionError on any contract
    violation.  ``survivors``: stream index -> tokens of every COMPLETED
    request of the takeover leg."""
    import tempfile

    from paddle_tpu_torch.distributed.launch.master import KVServer
    from paddle_tpu_torch.inference import (
        RequestJournal,
        RequestStatus,
        ServingEngine,
        ServingFrontend,
        StaleEpoch,
    )
    from paddle_tpu_torch.inference.ha import (EpochFence, FencedEngine,
                                               FrontendLease,
                                               StandbyFrontend)
    from paddle_tpu_torch.inference.tracing import (FlightRecorder,
                                                    TraceContext, Tracer,
                                                    events_digest,
                                                    tree_complete)

    model = _build_model(numpy_state, device, model_kw)
    dev = model.device
    reqs = _kill_request_stream(seed, num_requests)
    ref_tokens = _reference_tokens(model, reqs, replicas=2)

    journal_dir = journal_dir or tempfile.mkdtemp(
        prefix="paddle_tpu_torch_sby_")
    jpath = os.path.join(journal_dir, "requests.wal")
    kvs = KVServer(0).start()
    ep = f"127.0.0.1:{kvs.port}"
    t = [0.0]

    def clock():
        return t[0]

    # engines carry their own flight recorders (shared across both
    # incarnations, like the engines themselves), on the counter clock
    engines = [_CountingEngine(ServingEngine(
        model, trace_recorder=FlightRecorder(clock=clock, proc=f"r{i}"),
        clock=clock, device=dev, **ENGINE)) for i in range(2)]
    fences = [EpochFence() for _ in engines]

    def wrap():
        return [FencedEngine(e, f) for e, f in zip(engines, fences)]

    try:
        # ---- active incarnation: holds the lease; epoch armed but the
        # lease is NOT wired into step() — the resumed zombie must reach
        # the WORKER fence
        lease_a = FrontendLease(ep, ttl_s=30.0, holder="frontend-a",
                                clock=clock, seed=seed)
        assert lease_a.acquire() == 1
        fe_a = ServingFrontend(
            wrap(), journal=RequestJournal(jpath, fsync=False),
            epoch=lease_a.epoch, clock=clock,
            tracer=Tracer(clock=clock, proc="frontend-a"))
        rids = [fe_a.submit(p, max_new_tokens=m, priority=pr,
                            idempotency_key=f"req-{i}", **sk)
                for i, (p, m, pr, sk) in enumerate(reqs)]
        pre = {}
        paused = False
        for _ in range(max_steps):
            fe_a.step()
            t[0] += 1.0
            pre = dict(fe_a.results())
            in_flight = any(r.generated and rid not in pre
                            for rid, r in fe_a._requests.items())
            if len(pre) >= pause_after and in_flight:
                paused = True     # SIGSTOP analog: stop driving fe_a
                break
        assert paused, (
            "stream drained before the pause condition held — grow "
            "--requests or shrink --pause-after")

        # ---- lease expires while the active is paused; standby wins
        t[0] += lease_a.ttl_s + 1.0
        lease_b = FrontendLease(ep, ttl_s=30.0, holder="frontend-b",
                                clock=clock, seed=seed)
        standby = StandbyFrontend(
            lease_b, jpath, wrap,
            frontend_kwargs={"clock": clock,
                             "tracer": Tracer(clock=clock,
                                              proc="frontend-b")})
        fe_b = standby.poll()
        assert fe_b is not None and fe_b.epoch == 2, fe_b
        assert fe_b.metrics.counter("standby_takeovers_total") == 1
        assert fe_b.metrics.counter("failovers_total") == 1

        # ---- client replays every idempotency key to the new
        # incarnation: original rids, zero re-execution
        retry_rids = [fe_b.submit(p, max_new_tokens=m, priority=pr,
                                  idempotency_key=f"req-{i}", **sk)
                      for i, (p, m, pr, sk) in enumerate(reqs)]
        assert retry_rids == rids, (
            f"client retries re-executed instead of deduping: "
            f"{retry_rids} != {rids}")
        assert fe_b.metrics.counter("idempotent_hits_total") \
            == num_requests

        # ---- the zombie resumes while the successor is mid-run
        # (SIGCONT analog): every RPC lands typed StaleEpoch, the
        # engines execute NOTHING for it
        fe_b.step()
        steps_at_takeover = [e.step_calls for e in engines]
        fenced_before = sum(f.fenced_total for f in fences)
        zombie_typed = False
        try:
            fe_a.step()
        except StaleEpoch:
            zombie_typed = True
        assert zombie_typed and fe_a.deposed
        try:
            fe_a.step()              # deposed short-circuit, still typed
            raise AssertionError("deposed frontend stepped again")
        except StaleEpoch:
            pass
        try:
            fe_a.submit([1, 2], max_new_tokens=2)
            raise AssertionError("deposed frontend admitted a request")
        except StaleEpoch:
            pass
        zombie_fenced = sum(f.fenced_total for f in fences) - fenced_before
        assert zombie_fenced >= 1
        assert fe_a.metrics.counter("fenced_rpcs_total") >= 1
        assert [e.step_calls for e in engines] == steps_at_takeover, (
            "zombie RPCs reached an engine — duplicate token execution")

        # ---- successor drains; every admit has exactly one typed
        # terminal, survivors token-identical to the crash-free run
        res = fe_b.run(max_steps=max_steps)
        statuses = {}
        mismatched = []
        survivors = {}
        for i, rid in enumerate(rids):
            r = res[rid]
            statuses[r.status.value] = statuses.get(r.status.value, 0) + 1
            if rid in pre:
                assert r.detail.startswith("recovered terminal"), (
                    f"rid {rid} was terminal pre-pause but re-executed")
                assert r.status.value == pre[rid].status.value
                if pre[rid].status is RequestStatus.COMPLETED:
                    survivors[i] = list(pre[rid].tokens)
                    if pre[rid].tokens != ref_tokens[i]:
                        mismatched.append(rid)
            elif r.status is RequestStatus.COMPLETED:
                survivors[i] = list(r.tokens)
                if r.tokens != ref_tokens[i]:
                    mismatched.append(rid)
        assert not mismatched, (
            f"survivors diverged from crash-free run: {mismatched}")

        # ---- span-tree contract: the SUCCESSOR owns a complete tree
        # for every admit (recovered traces keep the journaled trace id)
        fleet_wide = 0
        for rid in rids:
            tree = fe_b.tracer.tree_for(TraceContext.mint(rid).trace_id)
            ok, why = tree_complete(tree)
            assert ok, f"rid {rid} post-takeover tree incomplete: {why}"
            tree_procs = {e["proc"]
                          for evs in tree.values() for e in evs}
            if len(tree_procs) > 1:
                fleet_wide += 1
        assert fleet_wide >= 1, "no successor tree crossed into an engine"

        # ---- handoff leg: clean early release, zero dropped admits,
        # no StaleEpoch anywhere
        j2 = os.path.join(journal_dir, "handoff.wal")
        fences2 = [EpochFence() for _ in engines]

        def wrap2():
            return [FencedEngine(e, f) for e, f in zip(engines, fences2)]

        lease_c = FrontendLease(ep, key="/serving/handoff-lease",
                                ttl_s=30.0, holder="frontend-c",
                                clock=clock, seed=seed)
        assert lease_c.acquire() == 1
        fe_c = ServingFrontend(
            wrap2(), journal=RequestJournal(j2, fsync=False),
            lease=lease_c, clock=clock)
        h_rids = [fe_c.submit(p, max_new_tokens=m, priority=pr,
                              idempotency_key=f"h-{i}", **sk)
                  for i, (p, m, pr, sk) in enumerate(reqs)]
        for _ in range(3):            # partial progress, then upgrade
            fe_c.step()
            t[0] += 1.0
        pre_h = dict(fe_c.results())
        fe_c.handoff()
        assert fe_c.handed_off
        assert fe_c.metrics.counter("handoffs_total") == 1
        lease_d = FrontendLease(ep, key="/serving/handoff-lease",
                                ttl_s=30.0, holder="frontend-d",
                                clock=clock, seed=seed)
        standby2 = StandbyFrontend(lease_d, j2, wrap2,
                                   frontend_kwargs={"clock": clock})
        fe_d = standby2.poll()        # immediate: released, no TTL wait
        assert fe_d is not None and fe_d.epoch == 2
        assert fe_d.metrics.counter("failovers_total") == 0
        h_retry = [fe_d.submit(p, max_new_tokens=m, priority=pr,
                               idempotency_key=f"h-{i}", **sk)
                   for i, (p, m, pr, sk) in enumerate(reqs)]
        assert h_retry == h_rids
        h_res = fe_d.run(max_steps=max_steps)
        h_mismatched = []
        for i, rid in enumerate(h_rids):
            r = h_res[rid]
            if rid in pre_h:
                if (pre_h[rid].status is RequestStatus.COMPLETED
                        and pre_h[rid].tokens != ref_tokens[i]):
                    h_mismatched.append(rid)
            elif (r.status is RequestStatus.COMPLETED
                    and r.tokens != ref_tokens[i]):
                h_mismatched.append(rid)
        assert not h_mismatched
        # zero dropped admitted requests + clean (never-fenced) handoff
        assert all(rid in h_res for rid in h_rids)
        assert sum(f.fenced_total for f in fences2) == 0, (
            "a clean handoff fenced something — zombie manufactured")
    finally:
        kvs.stop()

    return {
        "mode": "standby-in-process",
        "seed": seed,
        "device": dev.type,
        "requests": num_requests,
        "terminal_before_pause": len(pre),
        "recovered_requests":
            fe_b.metrics.counter("recovered_requests_total"),
        "idempotent_hits": fe_b.metrics.counter("idempotent_hits_total"),
        "takeover_epoch": fe_b.epoch,
        "failovers": fe_b.metrics.counter("failovers_total"),
        "standby_takeovers":
            fe_b.metrics.counter("standby_takeovers_total"),
        "zombie_fenced_rpcs": zombie_fenced,
        "zombie_executed_steps": 0,
        "statuses": statuses,
        "handoff_epoch": fe_d.epoch,
        "handoffs": fe_c.metrics.counter("handoffs_total"),
        "handoff_fenced_rpcs": 0,
        "survivors_token_identical": True,
        "exactly_one_terminal_per_admit": True,
        # counter-clocked + digest excludes t/seq: the standby replay
        # equality gate covers tracing too
        "trace_events": len(fe_b.tracer.all_events()),
        "trace_trees_complete": len(rids),
        "trace_fleet_wide": fleet_wide,
        "trace_digest": events_digest(fe_b.tracer.all_events()),
        "survivors": survivors,
    }


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
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=None,
                    help="request count (default: 18; the other modes use "
                         "their own defaults)")
    ap.add_argument("--max-request-retries", type=int, default=2)
    ap.add_argument("--no-poison", action="store_true")
    ap.add_argument("--brownout", action="store_true",
                    help="arm a BrownoutPolicy so degradation interleaves "
                         "with the fault schedule")
    ap.add_argument("--workers", type=int, default=0,
                    help="N>0: fleet mode — real serving_worker processes "
                         "with spec-armed failpoints")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the engines (workers, replicas, the "
                         "reference and the serve-phase child) run "
                         "(default cuda)")
    ap.add_argument("--numpy-state", default=None,
                    help=".npz of the JAX package's state_dict, loaded "
                         "over the seeded weights")
    ap.add_argument("--numpy-state-v2", default=None,
                    help="multitenant: .npz of the second weights "
                         "version's state_dict (seed 13)")
    ap.add_argument("--model-json", default=None,
                    help="the LlamaConfig keywords of the soak's model "
                         "(default: MODEL); in-process modes only")
    ap.add_argument("--kill-frontend", action="store_true",
                    help="durable-control-plane phase: SIGKILL a "
                         "journal-armed frontend child mid-soak, recover, "
                         "and assert exactly-one-terminal + idempotent-"
                         "retry dedupe + token-identical survivors")
    ap.add_argument("--kill-after", type=int, default=5,
                    help="kill-frontend: self-SIGKILL once this many "
                         "requests are terminal (with work in flight)")
    ap.add_argument("--serve-phase", action="store_true",
                    help="internal: the child half of --kill-frontend")
    ap.add_argument("--standby", action="store_true",
                    help="HA phase: lease-based standby failover + zombie "
                         "fencing; in-process by default, real processes "
                         "with --workers N")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregation phase: prefill/decode split over "
                         "a fenced KV fabric with the fabric.* failpoints "
                         "armed + a stale directory lease + prefill-"
                         "replica death")
    ap.add_argument("--spec", action="store_true",
                    help="speculative-decoding phase: a repetitive stream "
                         "over spec-armed replicas with the "
                         "engine.spec_draft and engine.spec_verify "
                         "failpoints both firing, replayed twice")
    ap.add_argument("--multitenant", action="store_true",
                    help="multi-tenant phase: steady-vs-bursty tenants "
                         "over three replicas, a warm-pool attach, a "
                         "rolling weight swap mid-traffic, and the "
                         "pool.refill / pool.attach / weights.swap "
                         "failpoints armed")
    ap.add_argument("--pause-after", type=int, default=None,
                    help="standby: pause/kill the active frontend once "
                         "this many requests are terminal (with work "
                         "in flight); default 4 in-process, 3 fleet")
    ap.add_argument("--zombie", action="store_true",
                    help="standby --workers: SIGSTOP/SIGCONT the active "
                         "frontend instead of SIGKILL (a true zombie)")
    ap.add_argument("--journal", default=None,
                    help="journal path (internal: --serve-phase, "
                         "--standby-serve-phase)")
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
        # per-mode defaults (an explicit --requests always wins): the
        # standby soaks are sized so the pause lands with work in flight
        if args.standby and args.workers > 0:
            args.requests = 10
        elif args.standby:
            args.requests = 14
        elif args.disagg:
            args.requests = 16
        elif args.spec:
            args.requests = 12
        elif args.workers > 0:
            args.requests = 8
        else:
            args.requests = 18
    if args.pause_after is None:
        args.pause_after = 3 if args.workers > 0 else 4
    model_kw = json.loads(args.model_json) if args.model_json else None
    common = dict(device=args.device, numpy_state=args.numpy_state)
    if model_kw is not None and args.workers > 0:
        ap.error("--model-json: the fleet soaks run MODEL")
    if args.serve_phase:
        serve_phase(args.journal, args.seed, args.requests,
                    args.kill_after, model_kw=model_kw, **common)
        return
    if args.standby_serve_phase:
        standby_serve_phase(args.master, args.journal, args.seed,
                            args.requests, args.pause_after,
                            args.self_kill)
        return
    inproc = dict(common, model_kw=model_kw)
    if args.standby and args.workers > 0:
        report = run_standby_fleet(seed=args.seed, workers=args.workers,
                                   num_requests=args.requests,
                                   pause_after=args.pause_after,
                                   zombie=args.zombie, **common)
    elif args.standby:
        report = run_standby(seed=args.seed, num_requests=args.requests,
                             pause_after=args.pause_after, **inproc)
    elif args.disagg:
        report = run_chaos_disagg(seed=args.seed,
                                  num_requests=args.requests, **inproc)
    elif args.multitenant:
        report = run_chaos_multitenant(
            seed=args.seed, num_requests=args.requests,
            numpy_state_v2=args.numpy_state_v2, **inproc)
    elif args.spec:
        report = run_chaos_spec(seed=args.seed, num_requests=args.requests,
                                **inproc)
    elif args.kill_frontend:
        report = run_kill_frontend(seed=args.seed,
                                   num_requests=args.requests,
                                   kill_after=args.kill_after, **inproc)
    elif args.workers > 0:
        report = run_chaos_fleet(seed=args.seed, workers=args.workers,
                                 num_requests=args.requests, **common)
    else:
        report = run_chaos(seed=args.seed, replicas=args.replicas,
                           num_requests=args.requests,
                           max_request_retries=args.max_request_retries,
                           poison=not args.no_poison,
                           brownout=args.brownout, **inproc)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
