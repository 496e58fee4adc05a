"""Cross-host serving fleet: remote ServingEngine replicas behind the
SLO-aware frontend (reference analogs: fleet elastic's worker registry +
health loop for membership, Orca/vLLM's scheduler-over-engine-workers
split for the data plane).

Copied from ``paddle_tpu/inference/fleet.py`` (the port never imports the
JAX package), with these adaptations:

* **Device rule.** Spawned workers run on ``cuda`` unless the caller asks
  for the CPU (``cpu_workers=True`` passes ``--device cpu``).  A worker
  without CUDA that was not asked for the CPU fails its boot with the
  device module's ``RuntimeError``; the fleet reports it as a spawn error
  and never retries on the CPU.
* **The worker lock.** A worker's rpc server answers each call on its own
  thread, and its blockwire listener serves pulls on another.  On the
  card a graphed program's first call per key captures a CUDA graph, and
  CUDA work from any other thread during the capture invalidates it, so
  every handler that issues CUDA work (step, add_request, evict, reap,
  export, import, the import half of a pull, swap, and the listener's
  ``export_blocks_packed``) runs under the one per-worker lock
  ``_WORKER["lock"]``.  ``_w_health`` takes no lock: each handler that
  changes the engine's state publishes its ``state_summary`` under the
  lock before it releases it (``_publish``), and the probe returns the
  last one published, so a heartbeat never waits behind a step's capture
  and never reads a summary from the middle of a step.
* **Host-only replies.** Every ``_w_*`` reply holds Python values, numpy
  arrays or CPU tensors (an ``export_blocks`` payload), never a CUDA
  tensor: the frontend process may have no CUDA context.
* **Weights.** ``_w_swap_weights`` and the worker boot build the port's
  ``LlamaForCausalLM`` on the engine's device from the spec's seed
  (``build_spec_model``); a spec may also name ``numpy_state``, a ``.npz``
  of the JAX package's ``state_dict`` loaded over the seeded build.
* **Call order.** A ``RemoteReplica`` call made while its
  ``begin_step`` RPC is in flight waits for that step to end first (the
  health probe excepted), so a worker runs the calls in the order the
  frontend made them, as an engine whose ``begin_step`` runs the step at
  once would.  Without it, a decode worker could take a request handed
  over during another replica's harvest into the step already issued,
  or not, depending on timing.  The worker numbers the summaries it
  publishes (``"seq"``), and a ``RemoteReplica`` keeps the newest: the
  reply of a step collected after such a hand-over's reply is older than
  the mirror and is not applied over it.
* ``worker_log`` still answers after ``shutdown()`` (the last 64 KiB of
  each reaped worker's log are kept): the worker's ``WORKER_EXIT`` line
  carries its kernel launch counts.

Three pieces, layered on four existing subsystems:

* **Worker side** — ``paddle_tpu_torch/tools/serving_worker.py`` builds a
  ``ServingEngine``
  in its own process (spawnable on another host), registers with the
  launch KV master, and serves the module-level ``_w_*`` handlers below
  over the ``distributed/rpc`` HTTP stack.  One ``_w_health`` probe
  returns engine scheduling state + a metrics snapshot — heartbeat,
  state mirror, and autoscaler all share it instead of growing three
  code paths.
* **``RemoteReplica``** — duck-types the exact ServingEngine surface
  ``ServingFrontend`` drives (``add_request``/``step``/``evict``/
  ``pop_finished`` + the capacity/scheduling attrs), proxying each call
  over RPC with a per-call timeout.  Every RPC piggybacks the worker's
  post-call ``state_summary`` so the frontend's local mirror of queue/
  slots/blocks is exactly what an in-process engine would show — which
  is why routing, priority admission, deadlines, and recompute
  preemption work unchanged, and why a local and a remote fleet produce
  token-identical schedules.  With megastep decode one step RPC
  returns up to ``megastep_k`` tokens per running sequence — the engine
  batches K decode iterations into one device loop (a CUDA graph on the
  card), so the per-token HTTP round trips collapse by K; host-side
  control (deadlines, cancel, autoscaling signals) runs at those
  megastep boundaries.
* **``ServingFleet``** — spawns/attaches workers (parallel process
  launch + KV-registration wait), builds the ``ServingFrontend`` over
  the ``RemoteReplica`` set, and adds what only the fleet layer can see:
  heartbeat health-checking (a silent worker — hung step, SIGKILL, or
  idle-but-dead — fails over via ``ServingFrontend.fail_replica``, which
  re-queues its in-flight requests from host-side state), drain-based
  scale-down (stop admitting, finish in-flight, deregister), and
  fleet-wide metrics aggregation (``ServingMetrics.merge`` +
  ``prometheus_text_fleet`` with a ``replica`` label).  The shared
  admission state (per-class token budgets, queue caps) already lives in
  the frontend, so it holds fleet-wide by construction.
* **``FleetAutoscaler``** — queue-depth / SLO-pressure policy object:
  scales up when queued work per accepting replica (or p95 TTFT) stays
  above target, drains the most idle worker after enough consecutive
  idle observations, never leaves fewer than ``min_workers`` accepting.
  Scale-up is NON-BLOCKING: ``spawn_worker_async`` launches the process
  and a background thread absorbs the worker's boot (torch import, model
  build); the step loop keeps serving and attaches the replica once its
  health probe answers (workers still booting count toward
  ``max_workers``).

Failure contract: any RPC fault (connection refused after SIGKILL, typed
``RpcTimeout`` from a hung worker) surfaces either in ``step()`` —
caught by the frontend's existing failover — or in the heartbeat, which
routes through the same path.  Requests are re-queued from frontend-side
state (prompt + tokens harvested so far) and finish on survivors with
greedy-identical tokens; nothing is dropped.  Fault containment on
top: heartbeat probes are idempotent and retry transient transport
faults with backoff before declaring a worker dead (data-plane ``step``
stays fail-fast into failover); spawn failures and early worker deaths
feed a ``RespawnCircuitBreaker`` the autoscaler consults before every
scale-up, so a crash-looping worker config backs off exponentially
(jittered) instead of paying a doomed boot per observation;
``spawn_errors`` is a bounded ring; and the ``fleet.spawn`` /
``fleet.heartbeat`` failpoints (``inference/faults.py``) let the chaos
soak drive all of it deterministically.

Durability: workers are separate processes, so they OUTLIVE a
crashed frontend.  Arm the frontend with a write-ahead journal
(``frontend_kwargs={"journal": path}``); after a frontend death, a new
process reattaches — ``discover_workers(master_endpoint)`` lists the
still-registered workers (external KV master), ``RemoteReplica`` each,
and ``ServingFrontend.recover(journal, replicas)`` reaps the orphaned
sequences worker-side (``_w_reap_orphans`` RPC; eviction publishes
their full KV blocks, so the recovered re-prefill largely hits the
prefix cache on the same worker) and re-admits from the journal.

High availability: every control RPC handler below is FENCED — it
carries the calling frontend's epoch (``epoch=`` kwarg,
stamped by ``RemoteReplica.set_epoch``), the worker's ``EpochFence``
remembers the highest epoch its process has ever seen, and an older
epoch raises the typed ``StaleEpoch`` before the handler touches the
engine.  This is what makes standby failover safe against zombies: a
SIGSTOP'd frontend resumed after its lease expired cannot know it was
deposed, but its first write lands as a typed rejection instead of
corrupting streams the new incarnation owns.  ``_w_health`` stays
unfenced (read-only; standbys watch through it) and reports the
highest epoch seen.  ``connect_workers`` is the standby's replica
factory: discovery + liveness probe + stale-entry pruning.

Scope note: each worker is one process / one engine on one device; an
engine sharded across cards *per replica* remains open.
"""
from __future__ import annotations

import concurrent.futures
import errno
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .control_plane import ServingFrontend
from .faults import FaultInjector, RespawnCircuitBreaker, register_failpoint
from .ha import EpochFence, StaleEpoch
from .metrics import (MEGASTEP_COUNTERS, SPEC_COUNTERS, ServingMetrics,
                      fold_counter_deltas, fold_prefix_counters)

__all__ = ["RemoteReplica", "ServingFleet", "FleetAutoscaler",
           "AutoscalePolicy", "WarmPool", "init_worker", "discover_workers",
           "connect_workers", "worker_roles"]

# warm-worker pool lifecycle edges: an attach pulled from the
# pool, and a refill launched to top it back up — both chaos-drivable
POOL_ATTACH = register_failpoint("pool.attach")
POOL_REFILL = register_failpoint("pool.refill")


def discover_workers(master_endpoint: str,
                     exclude: Sequence[str] = ("fleet-frontend",)
                     ) -> List[str]:
    """Worker names currently registered with the launch KV master —
    what a RESTARTED frontend reattaches to (recovery): workers
    are separate processes and outlive a crashed frontend, so recovery
    is ``[RemoteReplica(n) for n in discover_workers(ep)]`` (after
    ``rpc.init_rpc``/``refresh_workers``) handed to
    ``ServingFrontend.recover``, which reaps their orphaned sequences
    and re-admits from the journal.  Requires an external KV master (the
    production shape); a fleet that started its OWN in-process KVServer
    took the registry down with it.

    ``exclude`` filters non-worker registrations: the rpc layer
    registers EVERY participant under ``/rpc/workers/``, including
    frontends (``ServingFleet`` registers as ``fleet-frontend``; HA
    incarnations and standbys register under their own names) — and a
    SIGKILLed frontend never deregisters, so its stale entry would
    otherwise come back as a bogus "worker".  Any name CONTAINING
    ``"frontend"`` is excluded by construction (the repo's frontend
    naming convention — never name a worker that), plus the exact names
    in ``exclude``; pass the recovering process's own rpc name too if
    it does not match the convention."""
    from ..distributed.launch.master import KVClient

    kv = KVClient(master_endpoint)
    entries = kv.get_prefix("/rpc/workers/")
    names = (k.rsplit("/", 1)[-1] for k in entries)
    drop = set(exclude)
    # warm-pool workers are registered and serving-ready but
    # deliberately UNATTACHED — a recovering frontend must not adopt them
    # as serving replicas (the owning fleet's pool claims them); the
    # ``/serving/warm/<name>`` marker is deleted at claim time, so a
    # claimed-and-attached warm worker IS discoverable like any other
    drop |= {k.rsplit("/", 1)[-1] for k in kv.get_prefix("/serving/warm/")}
    return sorted(n for n in names if n not in drop and "frontend" not in n)


def worker_roles(master_endpoint: str) -> Dict[str, str]:
    """Disaggregation role labels registered alongside the workers
    (``/serving/roles/<name>``, written by tools/serving_worker.py right
    after its rpc registration).  The label ALSO rides every health
    reply (``RemoteReplica.role``), so this registry view exists for the
    paths that must know a worker's role without probing it — takeover
    planning, operator tooling — and as the KV-side source of truth a
    recovered frontend can audit its rebuilt fleet against."""
    from ..distributed.launch.master import KVClient

    entries = KVClient(master_endpoint).get_prefix("/serving/roles/")
    return {k.rsplit("/", 1)[-1]: v for k, v in entries.items()}


def worker_wires(master_endpoint: str) -> Dict[str, str]:
    """Data-plane listener endpoints registered alongside the workers
    (``/serving/wire/<name>``, written by tools/serving_worker.py right
    next to its role label).  Like the role label, the
    endpoint ALSO rides every health reply
    (``RemoteReplica.wire_endpoint``) — this registry view is for
    operator tooling and KV-side audits."""
    from ..distributed.launch.master import KVClient

    entries = KVClient(master_endpoint).get_prefix("/serving/wire/")
    return {k.rsplit("/", 1)[-1]: v for k, v in entries.items()}


# the only probe failures that PROVE nothing is listening at the
# advertised endpoint; every other OSError (reset, broken pipe) can come
# from a live worker's transient connection blip and must not prune
_DEAD_ENDPOINT_ERRNOS = frozenset({
    errno.ECONNREFUSED, errno.EHOSTUNREACH, errno.ENETUNREACH,
    errno.EHOSTDOWN, errno.ENETDOWN})


def _is_dead_endpoint(e: OSError) -> bool:
    # urllib surfaces a refused connect as URLError(reason=
    # ConnectionRefusedError) with errno=None on the wrapper — check
    # the wrapped reason too
    for err in (e, getattr(e, "reason", None)):
        if isinstance(err, ConnectionRefusedError) \
                or getattr(err, "errno", None) in _DEAD_ENDPOINT_ERRNOS:
            return True
    return False


def connect_workers(master_endpoint: str,
                    exclude: Sequence[str] = ("fleet-frontend",),
                    rpc_timeout: float = 60.0,
                    prune_stale: bool = True,
                    probe_timeout_s: float = 5.0) -> List["RemoteReplica"]:
    """``discover_workers`` + a liveness probe: wrap every discovered
    name in a ``RemoteReplica`` (whose constructor round-trips the
    health RPC) and SKIP the ones that don't answer — a dead worker's
    stale KV entry (SIGKILLed between heartbeats, host gone) must not
    come back as a bogus replica in a recovered frontend.
    ``prune_stale`` deletes the dead entries from the registry so the
    next discovery is clean — but ONLY for probes that failed with a
    definitive dead-endpoint error (connection refused, no route): a
    probe that merely TIMED OUT may be a live worker mid-megastep or
    mid-graph-capture, and one whose HANDLER raised (an armed
    ``health.probe`` failpoint, a transient engine error) answered over
    a healthy connection — registration is one-shot (``init_rpc``), so
    deleting either entry would delist a healthy worker forever.  Both
    are skipped this takeover and re-probed by the next discovery.
    ``probe_timeout_s`` bounds each liveness probe SEPARATELY from the
    replicas' data-plane ``rpc_timeout``: probes run sequentially, and a
    black-holed dead host (no RST, just silence) would otherwise burn
    the full step timeout per worker on the takeover path the lease TTL
    was tuned for.  Requires an rpc session (``rpc.init_rpc``);
    refreshes the routing table itself.  This is the
    ``replica_factory`` a ``StandbyFrontend`` should use."""
    from ..distributed import rpc
    from ..distributed.launch.master import KVClient

    rpc.refresh_workers()
    kv = KVClient(master_endpoint)
    # role-correct rebuild (disaggregation): the health reply carries the
    # worker's own role label; the KV registry entry backs it up so a
    # worker predating the label (or a probe that lost the field) still
    # lands in the right pool — a recovered frontend must never route
    # prefill passes to a decode-only worker or vice versa
    roles = {k.rsplit("/", 1)[-1]: v
             for k, v in kv.get_prefix("/serving/roles/").items()}
    out: List[RemoteReplica] = []
    for name in discover_workers(master_endpoint, exclude):
        try:
            rep = RemoteReplica(name, rpc_timeout=rpc_timeout,
                                probe_timeout=probe_timeout_s)
            if rep.role is None:
                rep.role = roles.get(name)
            out.append(rep)
        except rpc.RpcTimeout:
            continue           # live-but-slow ≠ stale: skip, never prune
        except OSError as e:
            # ...unless the error is REMOTE (rpc marks handler-raised
            # exceptions): a worker whose health handler raised an
            # OSError subclass — e.g. an armed health.probe failpoint of
            # kind timeout/drop — ANSWERED over a healthy connection
            if getattr(e, "_rpc_remote", False):
                continue
            # only DEFINITIVE dead-endpoint errnos may prune: a local
            # reset/broken-pipe is a transient blip (listener mid-
            # restart, full accept backlog) from a worker that is very
            # much alive — deleting its one-shot registration on that
            # would delist it forever
            if prune_stale and _is_dead_endpoint(e):
                kv.delete(f"/rpc/workers/{name}")
        # graft-lint: disable=typed-termination — liveness probe: the
        # worker ANSWERED (its handler raised), so it is alive and the
        # registry entry stays; the fault itself belongs to the caller
        # that eventually drives this worker, not to discovery
        except Exception:  # noqa: BLE001 — the worker ANSWERED (its
            continue       # handler raised): alive, keep the entry
    return out


class _BoundedErrors(OrderedDict):
    """Dict-shaped ring of the most recent errors: a crash-looping
    spawner must not grow ``ServingFleet.spawn_errors`` without bound.
    Oldest entries fall off past ``maxlen``; lookup/containment/iteration
    behave like the plain dict this replaces."""

    def __init__(self, maxlen: int = 32):
        super().__init__()
        self.maxlen = int(maxlen)

    def __setitem__(self, key, value):
        if key in self:
            del self[key]              # refresh recency
        super().__setitem__(key, value)
        while len(self) > self.maxlen:
            self.popitem(last=False)


# --------------------------------------------------------------------------
# worker side: process-global engine + module-level RPC handlers.  The rpc
# stack pickles functions BY REFERENCE (module + qualname), so these must be
# importable under the same path in the worker process.
# --------------------------------------------------------------------------
_WORKER: Dict[str, Any] = {
    "engine": None, "metrics": None, "stop": None, "name": None,
    "prefix_seen": (0, 0, 0), "mega_seen": (0, 0, 0, 0),
    "spec_seen": (0, 0, 0), "faults": None,
    "fence": EpochFence(), "role": None,
    # the last state summary a handler published, and its number
    "summary": None, "seq": 0,
    # held by every handler that issues CUDA work, and by the worker's
    # blockwire listener around its export (see the module docstring)
    "lock": threading.Lock(),
}


def build_spec_model(model_kwargs: Optional[Dict], seed: int,
                     bfloat16: bool = False, device=None,
                     numpy_state: Optional[str] = None):
    """The worker-spec recipe as a model: the port's ``LlamaForCausalLM``
    of ``LlamaConfig(**model_kwargs)`` on ``device`` (``None``: the card,
    a ``RuntimeError`` without CUDA), its parameters drawn from ``seed``;
    ``bfloat16`` casts a float32 build to bfloat16 (the config says so
    too, so an engine computes in it); ``numpy_state`` names an ``.npz``
    of the JAX package's ``state_dict`` as numpy, copied over the seeded
    weights.  In eval mode."""
    import numpy as np
    import torch

    from ..models.llama import LlamaConfig, LlamaForCausalLM
    from ..nn import load_numpy_state_dict

    model = LlamaForCausalLM(LlamaConfig(**(model_kwargs or {})),
                             device=device, seed=int(seed))
    if bfloat16 and model.config.dtype != "bfloat16":
        model = model.to(torch.bfloat16)
        model.config.dtype = "bfloat16"
    if numpy_state:
        with np.load(numpy_state) as sd:
            load_numpy_state_dict(model, {k: sd[k] for k in sd.files})
    model.eval()
    return model


def init_worker(engine, name: str,
                stop: Optional[threading.Event] = None,
                metrics: Optional[ServingMetrics] = None,
                fault_injector: Optional[FaultInjector] = None,
                role: Optional[str] = None) -> threading.Event:
    """Install ``engine`` as this process's served replica (called by
    tools/serving_worker.py before ``rpc.init_rpc``).  Returns the stop
    event ``_w_shutdown`` sets.  ``fault_injector`` arms the worker-side
    failpoints (``health.probe`` here; the engine carries its own
    ``engine.step`` site) for chaos runs.  A fresh ``EpochFence`` is
    armed too: it lives for the worker PROCESS — frontends come and go
    across it (that is the whole point), each bumping the highest epoch
    seen with its first control RPC.  ``role`` labels the worker for
    disaggregated serving ('prefill' = prefill passes only, 'decode' =
    decode placement only, None = both); it rides the health reply (so
    ``RemoteReplica``/``connect_workers`` rebuild role-correct fleets on
    takeover) and is stamped onto the engine for in-process callers."""
    if "frontend" in name:
        # discover_workers/connect_workers drop any registration whose
        # name contains "frontend" (that's how stale frontend-generation
        # entries are excluded) — a worker registered under such a name
        # would serve fine but be invisible to every takeover: never
        # probed, never orphan-reaped, decoding unobserved forever
        raise ValueError(
            f"worker name {name!r} contains 'frontend', which recovery "
            "discovery excludes by construction — pick another name")
    _WORKER["engine"] = engine
    _WORKER["metrics"] = metrics if metrics is not None else ServingMetrics()
    _WORKER["stop"] = stop if stop is not None else threading.Event()
    _WORKER["name"] = name
    _WORKER["prefix_seen"] = (0, 0, 0)
    _WORKER["mega_seen"] = (0, 0, 0, 0)
    _WORKER["spec_seen"] = (0, 0, 0)
    _WORKER["faults"] = (fault_injector if fault_injector is not None
                         else FaultInjector.from_env())
    _WORKER["fence"] = EpochFence()
    if role is not None and role not in ("prefill", "decode"):
        raise ValueError(
            f"worker role must be 'prefill', 'decode' or None, got {role!r}")
    _WORKER["role"] = role
    engine.role = role
    _publish(engine)
    return _WORKER["stop"]


def _engine():
    eng = _WORKER["engine"]
    if eng is None:
        raise RuntimeError("serving worker not initialised (init_worker)")
    return eng


def _fence(epoch, op: str):
    """Worker-side epoch fence, first line of every control
    RPC handler: the highest epoch this process has ever seen wins, and
    a call from an older one raises the typed ``StaleEpoch`` BEFORE the
    handler touches the engine — a zombie frontend's write lands as a
    typed rejection, never as duplicate token execution.  Unfenced
    (``epoch=None``) callers pass: fencing arms the moment any frontend
    carries an epoch.  Counted in the worker's ``fenced_rpcs_total``
    (the worker did the fencing, so the worker's registry — which the
    fleet scrape page exports — owns the count)."""
    try:
        _WORKER["fence"].check(epoch, op)
    except StaleEpoch:
        _WORKER["metrics"].inc("fenced_rpcs_total")
        raise


def _publish(eng) -> Dict:
    """Take ``eng.state_summary()`` and publish it for ``_w_health``,
    numbered in the order the worker took them (``"seq"``).  Called
    under the worker lock by every handler that changes the engine's
    state, before it releases the lock, and once at ``init_worker`` and
    after a worker's warm-up run, before the worker registers; so a probe
    reads the state as of the last such call, never one from the middle
    of a step."""
    _WORKER["seq"] += 1
    st = eng.state_summary()
    st["seq"] = _WORKER["seq"]
    _WORKER["summary"] = st
    return st


def _w_config() -> Dict:
    eng = _engine()
    return {
        "max_batch_size": eng.B, "token_budget": eng.T, "block_size": eng.bs,
        "max_seq_len": eng.max_seq_len, "num_blocks": eng.blocks.num_blocks,
        "cache_quant": eng.cache_quant, "pid": os.getpid(),
    }


def _w_add_request(prompt, max_new_tokens, eos_token_id=None,
                   sampling=None, sample_offset=0, epoch=None, trace=None,
                   deadline_s=None):
    _fence(epoch, "add_request")
    eng = _engine()
    # the trace wire context rides the RPC like epoch=: the
    # worker engine records its span events against the frontend's
    # attempt span, shipped back on the _w_step reply.  deadline_s is the
    # REMAINING deadline in seconds (relative, like the journal wire
    # form): the worker engine re-anchors it on its own clock and
    # freezes the row in-graph at the budget
    with _WORKER["lock"]:
        rid = eng.add_request(prompt, max_new_tokens=max_new_tokens,
                              eos_token_id=eos_token_id, sampling=sampling,
                              sample_offset=sample_offset, trace=trace,
                              deadline_s=deadline_s)
        return rid, _publish(eng)


def _w_step(epoch=None):
    """One engine step per RPC — which, with megastep decode,
    means up to ``megastep_k`` tokens per round trip: the per-token HTTP
    transport cost collapses by K."""
    _fence(epoch, "step")
    eng = _engine()
    with _WORKER["lock"]:
        emitted = eng.step()
        finished = eng.pop_finished()
        lp_fn = getattr(eng, "pop_token_logprobs", None)
        logprobs = lp_fn() if lp_fn is not None else {}
        if getattr(eng, "capture_sample_probs", False):
            # same drain the frontend does for in-process engines: nothing
            # ships the [V]-sized distributions over RPC, so a capture-
            # enabled worker spec must not accumulate them forever
            eng.pop_sample_probs()
        st = _publish(eng)
    m = _WORKER["metrics"]
    m.inc("engine_steps_total")
    n_tok = sum(len(t) for t in emitted.values())
    if n_tok:
        m.note_tokens(n_tok)
    m.set_gauge_peak("queue_depth", st["queue_depth"])
    m.set_gauge("running_requests", st["num_active"])
    m.set_gauge("blocks_capacity", st["blocks_total"])
    m.set_gauge("blocks_free", st["blocks_free"])
    m.set_gauge_peak("block_pool_utilization", st["pool_utilization"])
    ps = st.get("phase_seconds") or {}
    if ps:
        m.set_gauge("step_phase_schedule_seconds", ps.get("schedule", 0.0))
        m.set_gauge("step_phase_execute_seconds", ps.get("execute", 0.0))
        m.set_gauge("step_phase_harvest_seconds", ps.get("harvest", 0.0))
    # engine-level counters are monotone; fold the per-step deltas so
    # _w_reset_metrics windows stay correct
    pc = st.get("prefix_cache") or {}
    cur = (int(pc.get("hit_blocks", 0)), int(pc.get("miss_blocks", 0)),
           int(pc.get("evictions", 0)))
    _WORKER["prefix_seen"] = fold_prefix_counters(m, cur,
                                                  _WORKER["prefix_seen"])
    ms = st.get("megastep") or {}
    mcur = (int(ms.get("megasteps", 0)), int(ms.get("tokens", 0)),
            int(ms.get("mixed", 0)), int(ms.get("prefill_chunks", 0)))
    _WORKER["mega_seen"] = fold_counter_deltas(m, MEGASTEP_COUNTERS, mcur,
                                               _WORKER["mega_seen"])
    sp = st.get("spec") or {}
    scur = (int(sp.get("accepted", 0)), int(sp.get("drafted", 0)),
            int(sp.get("verify_forwards", 0)))
    _WORKER["spec_seen"] = fold_counter_deltas(m, SPEC_COUNTERS, scur,
                                               _WORKER["spec_seen"])
    m.inc("completed_total", len(finished))
    # span events the engine recorded this step (prefill done, megastep
    # boundaries) piggyback on the reply — the frontend grafts them onto
    # its fleet-wide trees (tracing disabled -> always [])
    pt_fn = getattr(eng, "pop_trace_events", None)
    traces = pt_fn() if pt_fn is not None else []
    return emitted, finished, st, logprobs, traces


def _w_pop_traces(epoch=None):
    """Drain the worker engine's buffered span events without stepping —
    the recovery-path drain: a takeover frontend pulls the spans a dead
    frontend never collected before it reaps.  Fenced like every control
    RPC (a zombie draining them would hide events from the successor)."""
    _fence(epoch, "pop_traces")
    eng = _engine()
    pt_fn = getattr(eng, "pop_trace_events", None)
    return pt_fn() if pt_fn is not None else []


def _w_evict(rid, epoch=None):
    _fence(epoch, "evict")
    eng = _engine()
    with _WORKER["lock"]:
        eng.evict(rid)
        return _publish(eng)


def _w_reap_orphans(epoch=None):
    """Evict every queued/active sequence on this worker — the recovery
    hook a RESTARTED frontend calls when it reattaches: the
    worker outlived the dead frontend, so whatever it is running belongs
    to nobody and would otherwise decode unobserved forever.  The
    recovered frontend re-admits the journaled requests afterwards (and
    with the prefix cache on, eviction published their full blocks, so
    the re-prefill largely hits cache on this same worker).

    With fencing armed this is the FIRST rpc of the new incarnation's
    epoch: the fence bumps here, so the dead/zombie frontend is locked
    out of this worker before recovery re-admits anything."""
    _fence(epoch, "reap_orphans")
    eng = _engine()
    with _WORKER["lock"]:
        n = eng.reap_orphans()
        st = _publish(eng)
    _WORKER["metrics"].inc("orphans_reaped_total", n)
    return n, st


def _w_export_blocks(hashes, epoch=None):
    """Bit-exact KV payload for a chain of published block hashes — the
    source side of the disaggregated prefill→decode transfer
    (inference/kv_fabric.py).  Fenced: a deposed frontend must not farm
    this worker's blocks out to replicas the current incarnation is not
    scheduling.  The payload holds CPU tensors (one device gather and
    one device-to-host copy) and ships over the pickle transport like any
    reply."""
    _fence(epoch, "export_blocks")
    eng = _engine()
    with _WORKER["lock"]:
        return eng.export_blocks(hashes)


def _w_import_blocks(payload, epoch=None):
    """Install a transferred KV payload into this worker's pool (the
    destination side of the disaggregated hop); returns the imported
    block count plus the post-import state summary so the frontend's
    mirror — including the prefix-hash set affinity routing reads —
    reflects the new content-addressable blocks immediately."""
    _fence(epoch, "import_blocks")
    eng = _engine()
    with _WORKER["lock"]:
        n = eng.import_blocks(payload)
        st = _publish(eng)
    _WORKER["metrics"].inc("fabric_blocks_imported_total", n)
    return n, st


def _w_pull_blocks(peer_endpoint, hashes, epoch=None):
    """Direct-wire transfer: THIS worker (the decode side)
    pulls a packed chain segment straight off ``peer_endpoint`` — the
    prefill worker's blockwire data-plane listener — and imports it.
    The frontend orchestrates with this directory-sized control RPC
    only; payload bytes take one hop instead of riding the pickle
    control channel through the frontend twice.  Fenced on BOTH ends:
    this RPC here, and the peer's listener fences the same epoch in
    the wire handshake before any payload bytes move.  Raises what the
    wire raised (typed WireError / StaleEpoch) — the frontend's fabric
    ladder owns the relay/recompute fallback.

    ``ServingEngine.pull_blocks`` in two halves: the wire read does no
    device work and runs outside the worker lock (two workers pulling
    from each other at once must not each hold its lock while waiting
    for the other's listener), the import runs under it."""
    from .blockwire import default_pool

    _fence(epoch, "pull_blocks")
    eng = _engine()
    header, raw = default_pool().pull(str(peer_endpoint), list(hashes),
                                      epoch=epoch)
    with _WORKER["lock"]:
        n = eng.import_blocks_packed(header, raw)
        st = _publish(eng)
    _WORKER["metrics"].inc("fabric_blocks_imported_total", n)
    _WORKER["metrics"].inc("fabric_wire_pulls_total")
    return n, len(raw), st


def _w_health(include_samples: bool = False):
    """The one shared probe: heartbeat liveness, autoscaler load signals,
    and metrics aggregation all read this."""
    inj = _WORKER.get("faults")
    if inj is not None:
        # a probe that raises here travels back as an RPC error — exactly
        # the shape a wedged health handler produces
        inj.fire("health.probe", detail=str(_WORKER.get("name")))
    # deliberately UNFENCED (read-only): standbys watch workers through
    # this probe, and a deposed frontend's monitoring may keep scraping.
    # It takes no worker lock and reads the summary the last handler
    # published (_publish): a heartbeat must not wait out a step's
    # first-call capture
    eng = _engine()
    return {
        "state": _WORKER["summary"],
        "metrics": _WORKER["metrics"].snapshot(include_samples=include_samples),
        "config": _w_config(),
        "draining": False,  # drain state is frontend-side; kept for probes
        "name": _WORKER["name"],
        "epoch": _WORKER["fence"].highest,   # highest epoch ever seen
        "role": _WORKER.get("role"),         # disaggregation label
        # data-plane listener endpoint: rides the probe like
        # the role label so RemoteReplica/connect_workers rebuild
        # wire-capable fleets on takeover without a KV read
        "wire": getattr(eng, "wire_endpoint", None),
    }


def _w_reset_metrics(epoch=None):
    """Zero the worker's registry (benches call this after the warmup/
    compile phase so engine-level counters cover the same measured window
    as the frontend's).  Fenced: a zombie must not erase the counters —
    including ``fenced_rpcs_total`` itself — out from under the current
    incarnation."""
    _fence(epoch, "reset_metrics")
    _WORKER["metrics"].reset()
    return True


def _w_swap_weights(model_kwargs, seed, version=None, model_id=None,
                    bfloat16=False, epoch=None, numpy_state=None):
    """Rebuild a seeded model from spec kwargs in THIS process, on the
    engine's device, and load it into the serving engine (rolling weight
    swap).  The wire form is the worker-spec recipe, not weight tensors:
    every replica of a version builds bit-identical weights from (seed,
    config) — plus, where the spec names one, the same ``numpy_state``
    file — exactly like boot, so a fleet-wide swap ships a few hundred
    bytes of JSON per worker instead of the checkpoint.  Fenced — a
    deposed frontend must not roll weights under the current incarnation
    — and the engine's own ``load_weights`` fires the ``weights.swap``
    failpoint and validates geometry BEFORE mutating, so a faulted swap
    leaves the old version serving.  Returns (installed version, state
    summary)."""
    _fence(epoch, "swap_weights")
    eng = _engine()
    with _WORKER["lock"]:
        model = build_spec_model(model_kwargs, seed, bfloat16,
                                 device=eng.device, numpy_state=numpy_state)
        v = eng.load_weights(model, version=version, model_id=model_id)
        st = _publish(eng)
    _WORKER["metrics"].inc("weight_swaps_total")
    return v, st


def _w_shutdown(epoch=None):
    # fenced: a deposed frontend must not shut down workers the current
    # incarnation is serving with
    _fence(epoch, "shutdown")
    _WORKER["stop"].set()
    return True


# --------------------------------------------------------------------------
# frontend side
# --------------------------------------------------------------------------
class _QView:
    """Mirror of one queued-but-unadmitted remote request; exposes the two
    things frontend headroom math reads (``len(prompt)``,
    ``max_new_tokens``)."""

    __slots__ = ("rid", "prompt", "max_new_tokens")

    def __init__(self, rid: int, prompt_len: int, max_new_tokens: int):
        self.rid = rid
        self.prompt = range(prompt_len)
        self.max_new_tokens = max_new_tokens


class _ActiveView:
    """Mirror of one running remote request; ``len(blocks)`` feeds the
    preemption victim-sizing math."""

    __slots__ = ("blocks",)

    def __init__(self, num_blocks: int):
        self.blocks = range(num_blocks)


class _RemoteBlockView:
    """BlockManager facade over the worker's last-synced pool state."""

    def __init__(self, num_blocks: int, num_free: int):
        self.num_blocks = num_blocks
        self.num_free = num_free


class RemoteReplica:
    """ServingEngine-shaped proxy for an engine living in a worker process.

    The frontend schedules against a local mirror of the worker's host-side
    state (queue, free slots, free blocks, per-request block counts); every
    RPC returns the worker's post-call ``state_summary`` and the mirror is
    replaced wholesale, so it is exactly as fresh as an in-process engine's
    own attributes between frontend operations.  All calls carry
    ``rpc_timeout`` — a hung worker raises ``RpcTimeout`` into the
    frontend's failover path instead of freezing the step loop."""

    # the worker folds its engine's prefix counters into its own registry
    # (_w_step), which the fleet scrape/merge paths already collect — the
    # frontend's gauge sampler must not fold the mirror a second time
    prefix_counters_self_reported = True

    # the worker counts each fence into its own scraped registry, so
    # the frontend must not count it again (see ServingFrontend._fenced)
    fences_self_reported = True

    def __init__(self, worker_name: str, rpc_timeout: float = 60.0,
                 probe_timeout: Optional[float] = None):
        from ..distributed import rpc

        self._rpc = rpc
        self.worker = worker_name
        self.rpc_timeout = float(rpc_timeout)
        # fencing epoch: stamped by the owning frontend via
        # set_epoch and carried on every control RPC; the worker rejects
        # older epochs with the typed StaleEpoch.  None = unfenced.
        self._epoch: Optional[int] = None
        # the constructor's liveness probe may use a SHORTER deadline
        # than data-plane calls: discovery over N workers probes them
        # sequentially, and a black-holed host would otherwise burn the
        # full step timeout per dead worker on the takeover path
        t = (float(probe_timeout) if probe_timeout is not None
             else self.rpc_timeout)
        h = self._rpc.rpc_sync(self.worker, _w_health, timeout=t)
        cfg = h["config"]
        # disaggregation role label (init_worker): rides every health
        # reply so a takeover frontend rebuilds a role-correct fleet
        self.role = h.get("role")
        # data-plane listener endpoint: the fabric ladder
        # reads this off the SOURCE replica to decide the wire rung
        self.wire_endpoint = h.get("wire")
        self.B = int(cfg["max_batch_size"])
        self.T = int(cfg["token_budget"])
        self.bs = int(cfg["block_size"])
        self.max_seq_len = int(cfg["max_seq_len"])
        self.cache_quant = cfg["cache_quant"]
        self.pid = cfg["pid"]
        self.blocks = _RemoteBlockView(int(cfg["num_blocks"]),
                                       int(cfg["num_blocks"]))
        self._queue: List[_QView] = []
        self._active: Dict[int, _ActiveView] = {}
        self._free_slots: List[int] = list(range(self.B))
        self._finished: Dict[int, List[int]] = {}
        self._logprobs: Dict[int, List[float]] = {}
        self._trace_events: List[Dict] = []  # worker spans off _w_step replies
        self._pending_step = None
        self._state_seq = -1     # the newest worker summary applied
        self._apply_state(h["state"])

    # ------------------------------------------------------------ plumbing
    def _call(self, fn, *args, **kwargs):
        # a step issued by begin_step runs before any later call: the
        # frontend hands a decode replica its requests while harvesting
        # another replica's step, after this one's step RPC went out, and
        # the worker must not take them into the step already issued
        fut = self._pending_step
        if fut is not None:
            concurrent.futures.wait([fut], timeout=self.rpc_timeout)
        return self._rpc.rpc_sync(self.worker, fn, args=args,
                                  kwargs=kwargs, timeout=self.rpc_timeout)

    def set_epoch(self, epoch: int):
        """Stamp the caller epoch every subsequent control RPC carries
        (the frontend propagates its epoch here at attach/recover)."""
        self._epoch = int(epoch)

    def _apply_state(self, st: Dict):
        # the worker numbers its summaries in the order it took them: one
        # no newer than the mirror (a step's reply collected after the
        # reply of a call that waited for that step, a probe's copy of a
        # summary already applied) is dropped
        seq = st.get("seq")
        if seq is not None:
            if seq <= self._state_seq:
                return
            self._state_seq = seq
        self._queue = [_QView(rid, pl, mn) for rid, pl, mn in st["queued"]]
        self._active = {rid: _ActiveView(nb)
                        for rid, nb in st["active"].items()}
        self._free_slots = list(range(st["free_slots"]))
        self.blocks.num_free = int(st["blocks_free"])
        # prefix-cache mirror: the hash summary feeds frontend-side
        # prefix-affinity routing, the counters feed _sample_gauges —
        # exactly the attributes an in-process engine exposes
        pc = st.get("prefix_cache") or {}
        self.prefix_cache_enabled = bool(pc.get("enabled"))
        self._prefix_hashes = frozenset(pc.get("hashes") or ())
        self.prefix_hit_blocks = int(pc.get("hit_blocks", 0))
        self.prefix_miss_blocks = int(pc.get("miss_blocks", 0))
        self.prefix_evictions = int(pc.get("evictions", 0))
        # megastep mirror (the worker folds these into its own registry;
        # prefix_counters_self_reported keeps the frontend from double-
        # counting the mirror, same as the prefix counters)
        ms = st.get("megastep") or {}
        self.megastep_k = int(ms.get("k", 1))
        self.megasteps = int(ms.get("megasteps", 0))
        self.megastep_tokens = int(ms.get("tokens", 0))
        self.megasteps_mixed = int(ms.get("mixed", 0))
        self.prefill_chunks = int(ms.get("prefill_chunks", 0))
        # speculative-decode mirror: same self-reported fold
        # contract as the megastep counters above
        sp = st.get("spec") or {}
        self.spec_k = int(sp.get("k", 0))
        self.spec_accepted_tokens = int(sp.get("accepted", 0))
        self.spec_draft_tokens = int(sp.get("drafted", 0))
        self.spec_verify_forwards = int(sp.get("verify_forwards", 0))
        # per-phase step-time mirror (the worker sets the gauges in its
        # own registry too; the frontend sums mirrors like the block
        # counts above)
        self.phase_seconds = dict(st.get("phase_seconds") or {})
        # weights identity mirror: version label for metrics/
        # trace attribution and model id for tenant-affine routing — the
        # frontend reads these exactly like an in-process engine's attrs
        self.weights_version = st.get("weights_version", "v0")
        self.model_id = st.get("model_id", "default")

    def cached_block_hashes(self):
        """Last-synced mirror of the worker engine's content-addressable
        block hashes (piggybacked on every RPC reply)."""
        return self._prefix_hashes

    # ----------------------------------------------- ServingEngine surface
    @property
    def num_active(self) -> int:
        return len(self._active)

    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    sampling=None, sample_offset: int = 0,
                    trace: Optional[Dict] = None,
                    deadline_s: Optional[float] = None) -> int:
        prompt = [int(t) for t in prompt_ids]
        if sampling is not None and not isinstance(sampling, dict):
            # ship the dict wire form (no class pickling across versions)
            sampling = sampling.to_wire()
        rid, st = self._call(_w_add_request, prompt, int(max_new_tokens),
                             eos_token_id, sampling, int(sample_offset),
                             epoch=self._epoch, trace=trace,
                             deadline_s=deadline_s)
        self._apply_state(st)
        return rid

    def begin_step(self):
        """Issue the step RPC without waiting (the frontend calls this on
        every replica first, then collects via ``step()`` — concurrent
        replicas overlap their engine steps instead of serializing the
        HTTP round trips)."""
        if self._pending_step is None:
            self._pending_step = self._rpc.rpc_async(
                self.worker, _w_step, kwargs={"epoch": self._epoch},
                timeout=self.rpc_timeout)

    def step(self) -> Dict[int, List[int]]:
        fut = self._pending_step
        self._pending_step = None
        if fut is not None:
            emitted, finished, st, lps, traces = fut.result()
        else:
            emitted, finished, st, lps, traces = self._call(
                _w_step, epoch=self._epoch)
        self._apply_state(st)
        self._finished.update(finished)
        for rid, vals in lps.items():
            self._logprobs.setdefault(rid, []).extend(vals)
        if traces:
            self._trace_events.extend(traces)
        return emitted

    def pop_trace_events(self) -> List[Dict]:
        """Local drain of the worker span events buffered off ``_w_step``
        replies — same shape as ``ServingEngine.pop_trace_events``, and
        crucially NOT an RPC (the frontend drains it after stepping, so
        a dead worker cannot fault the trace harvest)."""
        out = self._trace_events
        self._trace_events = []
        return out

    def pop_remote_traces(self) -> List[Dict]:
        """``_w_pop_traces`` RPC: pull span events the worker recorded
        but never shipped (no step happened, or the previous frontend
        died before collecting) — the recovery/takeover drain."""
        evs = self._call(_w_pop_traces, epoch=self._epoch)
        if evs:
            self._trace_events.extend(evs)
        return self.pop_trace_events()

    def pop_finished(self) -> Dict[int, List[int]]:
        out = self._finished
        self._finished = {}
        return out

    def pop_token_logprobs(self) -> Dict[int, List[float]]:
        out = self._logprobs
        self._logprobs = {}
        return out

    def evict(self, rid: int):
        st = self._call(_w_evict, rid, epoch=self._epoch)
        self._apply_state(st)

    def reap_orphans(self) -> int:
        """Evict every sequence the worker is running (crash recovery:
        the worker outlived its frontend and those sequences are
        orphans); returns the count.  ``ServingFrontend.recover`` calls
        this on every still-live replica before re-admitting from the
        journal."""
        n, st = self._call(_w_reap_orphans, epoch=self._epoch)
        self._apply_state(st)
        self._finished.clear()
        self._logprobs.clear()
        return int(n)

    def export_blocks(self, hashes) -> Dict:
        """Pull a bit-exact KV payload off the worker (source side of a
        disaggregated block transfer, kv_fabric.py)."""
        return self._call(_w_export_blocks, list(hashes),
                          epoch=self._epoch)

    def import_blocks(self, payload: Dict) -> int:
        """Push a transferred KV payload into the worker's pool; the
        reply's state summary refreshes the mirror so prefix-affinity
        routing sees the imported hashes immediately."""
        n, st = self._call(_w_import_blocks, payload, epoch=self._epoch)
        self._apply_state(st)
        return int(n)

    def pull_blocks(self, peer_endpoint: str, hashes,
                    epoch: Optional[int] = None) -> Tuple[int, int]:
        """Make the worker pull a chain segment DIRECTLY off a peer's
        data-plane listener (``_w_pull_blocks``: the payload
        never touches this frontend — only this directory-sized control
        RPC does.  The worker's stamped epoch rides both the RPC and
        the wire handshake; the ``epoch`` parameter exists for engine-
        surface compatibility and is superseded by the stamp.  Returns
        ``(blocks_imported, payload_bytes)``."""
        n, nbytes, st = self._call(_w_pull_blocks, str(peer_endpoint),
                                   list(hashes),
                                   epoch=self._epoch if self._epoch
                                   is not None else epoch)
        self._apply_state(st)
        return int(n), int(nbytes)

    def load_weights(self, spec: Dict, version: Optional[str] = None,
                     model_id: Optional[str] = None) -> str:
        """Rolling-swap this worker to new version-labelled weights.
        Duck-types ``ServingEngine.load_weights`` for the frontend's swap
        drivers, but takes the worker-spec RECIPE — ``{"seed": ..,
        "model": {LlamaConfig kwargs}, "bfloat16": .., "numpy_state":
        ..}`` — not a model instance: the worker rebuilds the seeded weights
        itself (``_w_swap_weights``), so nothing tensor-sized crosses
        the wire and every replica of a version is bit-identical by
        construction.  Raises whatever the worker-side swap raised (an
        armed ``weights.swap`` failpoint, a geometry ValueError); the
        worker keeps its old version on any fault."""
        v, st = self._call(_w_swap_weights, dict(spec.get("model") or {}),
                           int(spec.get("seed", 0)), version, model_id,
                           bool(spec.get("bfloat16", False)),
                           epoch=self._epoch,
                           numpy_state=spec.get("numpy_state"))
        self._apply_state(st)
        return v

    # --------------------------------------------------- fleet-layer extras
    def health(self, include_samples: bool = False,
               timeout: Optional[float] = None, retries: int = 0,
               retry_backoff_s: float = 0.05) -> Dict:
        """Probe the worker; ``timeout`` overrides the data-plane timeout
        (heartbeats use a short one so a hung worker is detected within
        ~a heartbeat interval, not after a full data-plane deadline).

        ``retries`` re-issues the probe after transient transport faults
        (RpcTimeout / connection errors) with exponential backoff — the
        probe is idempotent and read-only, so retrying is always safe,
        and one dropped packet must not fail over a healthy worker.  The
        data-plane ``step`` path deliberately has NO retry: it is not
        idempotent from the frontend's view (tokens could be emitted
        twice) and the existing failover re-queue already recovers it
        exactly."""
        last: Optional[BaseException] = None
        for attempt in range(int(retries) + 1):
            if attempt:
                time.sleep(retry_backoff_s * (2.0 ** (attempt - 1)))
            try:
                h = self._rpc.rpc_sync(self.worker, _w_health,
                                       args=(include_samples,),
                                       timeout=self.rpc_timeout
                                       if timeout is None else timeout)
                break
            except (TimeoutError, ConnectionError, OSError) as e:
                last = e       # transient transport shapes: retry
        else:
            raise last
        self._apply_state(h["state"])
        return h

    def request_shutdown(self, timeout: Optional[float] = None):
        self._rpc.rpc_sync(self.worker, _w_shutdown,
                           kwargs={"epoch": self._epoch},
                           timeout=self.rpc_timeout
                           if timeout is None else timeout)


@dataclass
class AutoscalePolicy:
    """Knobs for ``FleetAutoscaler`` (all observation-count based so tests
    can drive it deterministically with an injected clockless loop)."""

    min_workers: int = 1
    max_workers: int = 4
    # scale up when queued requests per accepting replica exceed this...
    scale_up_queue_per_replica: float = 2.0
    # ...or when p95 TTFT (from the frontend registry) exceeds this SLO
    scale_up_ttft_p95_s: Optional[float] = None
    # consecutive pressured/idle observations required to act
    up_after: int = 2
    down_after: int = 3
    # observations to wait after any scale action before the next one
    cooldown: int = 2


class FleetAutoscaler:
    """Queue-depth / SLO-pressure replica autoscaler.

    Call ``observe()`` once per control-plane iteration (ServingFleet does
    this from ``step()``).  Decisions: spawn a worker when sustained
    pressure (non-blocking — the boot happens off the step loop and the
    replica attaches when ready; booting workers count as capacity so
    pressure during the boot can't over-spawn), drain the most idle
    worker when sustained idleness, hold otherwise.  Drain = stop
    admitting (frontend ``draining`` flag), finish in-flight, deregister
    + reap (ServingFleet completes it once the replica is empty)."""

    def __init__(self, fleet: "ServingFleet",
                 policy: Optional[AutoscalePolicy] = None):
        self.fleet = fleet
        self.policy = policy or AutoscalePolicy()
        self._pressure = 0
        self._idle = 0
        self._cooldown = 0
        self.actions: List[str] = []  # audit trail ("up:worker2", ...)

    def observe(self) -> str:
        """One autoscaling observation; returns 'up', 'down', or 'hold'."""
        pol = self.policy
        fe = self.fleet.frontend
        if fe is None:  # fleet created with num_workers=0, none spawned yet
            return "hold"
        accepting = [r for r in fe.replicas if r.alive and not r.draining]
        if self._cooldown > 0:
            self._cooldown -= 1
            return "hold"
        queue_depth = len(fe._queue)
        per_rep = queue_depth / max(len(accepting), 1)
        pressured = per_rep > pol.scale_up_queue_per_replica
        if not pressured and pol.scale_up_ttft_p95_s is not None:
            # summary(), not snapshot(): this runs every fleet step and a
            # full snapshot sorts every latency buffer just to read one p95
            p95 = fe.metrics.summary("ttft_seconds")["p95"]
            pressured = p95 > pol.scale_up_ttft_p95_s
        busy = queue_depth > 0 or any(len(r.requests) for r in accepting)
        self._pressure = self._pressure + 1 if pressured else 0
        self._idle = self._idle + 1 if not busy else 0

        # workers already booting count as capacity on the way — without
        # this, every observation during the boot would spawn one
        # more (the non-blocking spawn returns before the worker exists)
        pending = getattr(self.fleet, "num_pending_spawns", 0)
        if (self._pressure >= pol.up_after
                and len(accepting) + pending < pol.max_workers):
            # respawn circuit breaker: after K spawn-or-early-death
            # failures the fleet stops paying a doomed boot per
            # observation; pressure is NOT reset, so the next allow()
            # (half-open probe after the jittered backoff) retries
            # immediately instead of re-accumulating up_after signals
            breaker = getattr(self.fleet, "spawn_breaker", None)
            if breaker is not None and not breaker.allow():
                if not self.actions or self.actions[-1] != "breaker:hold":
                    self.actions.append("breaker:hold")
                return "hold"
            spawn = getattr(self.fleet, "spawn_worker_async", None)
            name = spawn() if spawn is not None else self.fleet.spawn_worker()
            self.actions.append(f"up:{name}")
            self._pressure = 0
            self._cooldown = pol.cooldown
            return "up"
        if (self._idle >= pol.down_after
                and len(accepting) > pol.min_workers):
            victim = min(accepting, key=lambda r: len(r.requests))
            self.fleet.drain_replica(victim)
            self.actions.append(f"down:{victim.engine.worker}")
            self._idle = 0
            self._cooldown = pol.cooldown
            return "down"
        return "hold"


class WarmPool:
    """Pre-booted worker pool: scale-up as attach, not boot.

    A *warm* worker has already paid the boot — torch import, seeded
    weight build, and the step/megastep programs' first calls (on the
    card their eager runs and CUDA graph captures, driven by a throwaway
    sub-block request, so nothing lands in the prefix cache) —
    and parks registered-but-unattached behind a ``/serving/warm/<name>``
    KV marker.  ``FleetAutoscaler`` scale-up then claims one (a single
    health probe, ~ms) instead of spawning cold; the pool refills
    asynchronously behind the claim.

    The pool is deliberately host-mechanism-agnostic: ``spawn_fn(name)``
    launches one warm worker and either returns a ready handle
    immediately (synchronous fakes in tests) or returns ``None`` and
    arranges for ``note_ready(name, handle)`` / ``note_failed(name)``
    when the boot resolves (``ServingFleet`` does this on a daemon
    thread).  The spawn ``breaker`` is consulted before every refill —
    a crash-looping warm config backs off exactly like cold respawns —
    and both lifecycle edges fire chaos-drivable failpoints:
    ``pool.refill`` when a refill launches, ``pool.attach`` when a claim
    hands a worker out (a faulted claim re-pools the worker and the
    caller falls back to a cold spawn).

    Weight-swap coherence: the pool carries a ``generation``; a rolling
    weight swap drains the ready set and bumps it, so a warm worker that
    finished booting with pre-swap weights is refused by ``note_ready``
    and reaped by its owner instead of ever serving stale weights.

    Counters: ``pool_refills_total`` / ``pool_attaches_total`` /
    ``pool_attach_failures_total``; depth (ready + booting) is the
    ``warm_pool_depth`` gauge."""

    def __init__(self, size: int, spawn_fn: Callable[[str], Any], *,
                 breaker: Optional[RespawnCircuitBreaker] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 metrics: Optional[ServingMetrics] = None,
                 name_prefix: str = "warm"):
        self.size = int(size)
        self.spawn_fn = spawn_fn
        self.breaker = breaker
        self.faults = fault_injector
        self.metrics = metrics
        self.name_prefix = name_prefix
        self.generation = 0
        self._lock = threading.Lock()
        self._ready: List = []                 # guarded-by: self._lock
        self._pending: Dict[str, int] = {}     # guarded-by: self._lock
        self._next = 0

    def _inc(self, name: str, n: int = 1):
        if self.metrics is not None:
            self.metrics.inc(name, n)

    def _sample_depth(self):
        if self.metrics is not None:
            self.metrics.set_gauge("warm_pool_depth", self.depth())

    def depth(self) -> int:
        """Ready + booting warm workers (the scale-up headroom gauge)."""
        with self._lock:
            return len(self._ready) + len(self._pending)

    def ready_names(self) -> List[str]:
        with self._lock:
            return [name for name, _ in self._ready]

    def refill(self) -> int:
        """Launch warm boots until depth reaches ``size``; returns how
        many were launched.  Consults the spawn breaker first (a pool
        must not crash-loop past containment just because it is a pool)
        and stops at the first spawn fault — the breaker holds the next
        attempt, and the periodic maintain retries after backoff."""
        launched = 0
        while self.depth() < self.size:
            if self.breaker is not None and not self.breaker.allow():
                break
            with self._lock:
                name = f"{self.name_prefix}{self._next}"
                self._next += 1
                self._pending[name] = self.generation
            try:
                if self.faults is not None:
                    self.faults.fire(POOL_REFILL, detail=name)
                handle = self.spawn_fn(name)
            # graft-lint: disable=typed-termination — refill containment:
            # any spawn fault (armed pool.refill, Popen failure) feeds the
            # breaker and the next maintain retries after its backoff
            except Exception:  # noqa: BLE001
                with self._lock:
                    self._pending.pop(name, None)
                if self.breaker is not None:
                    self.breaker.record_failure()
                self._inc("spawn_failures_total")
                self._sample_depth()
                break
            self._inc("pool_refills_total")
            launched += 1
            if handle is not None:     # synchronous spawn: ready now
                self.note_ready(name, handle)
        self._sample_depth()
        return launched

    def note_ready(self, name: str, handle: Any = None) -> bool:
        """A warm boot finished; pool it — unless the generation moved
        on (weights were swapped mid-boot), in which case the worker
        holds stale weights: refuse it (returns False) so the owner
        reaps it instead of ever attaching it."""
        with self._lock:
            gen = self._pending.pop(name, None)
            if gen is not None and gen != self.generation:
                self._sample_depth()
                return False
            self._ready.append((name, handle))
        self._sample_depth()
        return True

    def note_failed(self, name: str, record: bool = True):
        """A warm boot died; release its seat.  ``record=False`` when
        the caller's own spawn machinery already fed the breaker."""
        with self._lock:
            self._pending.pop(name, None)
        if record and self.breaker is not None:
            self.breaker.record_failure()
        self._sample_depth()

    def claim(self):
        """Pop the oldest ready warm worker as ``(name, handle)``, or
        ``None`` when the pool is empty (caller falls back to a cold
        spawn).  Fires ``pool.attach``; a faulted attach re-pools the
        worker (it is still warm and healthy — the fault was the attach
        edge) and returns ``None``."""
        with self._lock:
            if not self._ready:
                return None
            item = self._ready.pop(0)
        try:
            if self.faults is not None:
                self.faults.fire(POOL_ATTACH, detail=item[0])
        # graft-lint: disable=typed-termination — attach containment: the
        # worker goes back in the pool and the caller cold-spawns instead
        except Exception:  # noqa: BLE001
            self._inc("pool_attach_failures_total")
            with self._lock:
                self._ready.insert(0, item)
            return None
        self._inc("pool_attaches_total")
        self._sample_depth()
        return item

    def drain_ready(self, bump_generation: bool = True) -> List:
        """Remove and return every ready worker (rolling swap / shutdown
        — the caller owns reaping them).  Bumping the generation makes
        still-booting workers stale: their ``note_ready`` is refused."""
        with self._lock:
            ready, self._ready = self._ready, []
            if bump_generation:
                self.generation += 1
        self._sample_depth()
        return ready


class ServingFleet:
    """Remote-replica data plane: worker processes + frontend + heartbeat.

    >>> fleet = ServingFleet(worker_spec={"seed": 11, "model": {...},
    ...                                   "engine": {...}}, num_workers=2)
    >>> rid = fleet.frontend.submit([1, 5, 7], max_new_tokens=16)
    >>> results = fleet.run()
    >>> fleet.shutdown()

    ``worker_spec`` is the JSON-able model/engine recipe every spawned
    worker builds (seeded identically, so greedy decode is replica-
    independent).  Pass ``master_endpoint`` to join an existing KV master
    (e.g. workers pre-started on other hosts via ``attach_worker``);
    otherwise the fleet starts its own in-process ``KVServer``.
    Spawned workers run on ``cuda`` (the port's device rule): a worker
    without CUDA fails its boot with the device module's
    ``RuntimeError``, reported as a spawn error, never retried on the CPU.
    ``cpu_workers=True`` passes ``--device cpu`` (the tests; the workers
    then also get ``OMP_NUM_THREADS=1`` unless it is set, so several
    share a host's cores)."""

    def __init__(self, worker_spec: Dict, num_workers: int = 0, *,
                 master_endpoint: Optional[str] = None,
                 worker_roles: Optional[Sequence[Optional[str]]] = None,
                 frontend_kwargs: Optional[Dict] = None,
                 rpc_timeout: float = 60.0,
                 spawn_timeout: float = 120.0,
                 heartbeat_interval_s: float = 1.0,
                 heartbeat_timeout_s: float = 5.0,
                 heartbeat_retries: int = 1,
                 cpu_workers: bool = False,
                 autoscaler_policy: Optional[AutoscalePolicy] = None,
                 spawn_breaker: Optional[RespawnCircuitBreaker] = None,
                 early_death_s: float = 20.0,
                 max_spawn_errors: int = 32,
                 fault_injector: Optional[FaultInjector] = None,
                 warm_pool_size: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        from ..distributed import rpc
        from ..distributed.launch.master import KVClient, KVServer

        self.worker_spec = dict(worker_spec)
        # disaggregation: role label per launch index ('prefill'/'decode'/
        # None); workers past the list launch unlabeled.  The label is
        # injected into each worker's spec JSON, so it rides the same
        # wire the engine config does and survives respawns by name.
        self.worker_roles = (list(worker_roles)
                             if worker_roles is not None else [])
        self.rpc_timeout = float(rpc_timeout)
        self.spawn_timeout = float(spawn_timeout)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        # idempotent health probes survive one transient transport fault
        # by default; data-plane step RPCs stay fail-fast into failover
        self.heartbeat_retries = int(heartbeat_retries)
        self.cpu_workers = bool(cpu_workers)
        self._clock = clock
        self._rpc = rpc
        # respawn containment: spawn failures and early worker deaths feed
        # this breaker; the autoscaler consults it before every spawn, so
        # a crash-looping worker config backs off exponentially instead of
        # burning a boot per observation forever.  Async boot
        # threads race record_failure against the control thread's
        # allow/record_success/open_gauge — the breaker locks its own
        # state machine, so no caller-side locking is needed here
        self.spawn_breaker = (spawn_breaker if spawn_breaker is not None
                              else RespawnCircuitBreaker(clock=clock))
        self.early_death_s = float(early_death_s)
        self._attached_at: Dict[str, float] = {}
        self._faults = (fault_injector if fault_injector is not None
                        else FaultInjector.from_env())
        self._max_spawn_errors = int(max_spawn_errors)
        self._kv_server = None
        if master_endpoint is None:
            self._kv_server = KVServer(0).start()
            master_endpoint = f"127.0.0.1:{self._kv_server.port}"
        self.master_endpoint = master_endpoint
        self._kv = KVClient(master_endpoint)
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, str] = {}
        # the last 64 KiB of each reaped worker's log (worker_log)
        self._final_logs: Dict[str, str] = {}
        self._next_worker = 0
        self._last_heartbeat = -float("inf")
        # non-blocking scale-up state: background threads wait out worker
        # boot (torch import + model build) and park the ready
        # RemoteReplica here; step() attaches it on the control thread so
        # frontend structures are never mutated concurrently
        self._spawn_lock = threading.Lock()
        self._pending_spawns: Dict[str, threading.Thread] = {}  # guarded-by: self._spawn_lock
        self._ready_replicas: List = []                         # guarded-by: self._spawn_lock
        # guarded-by: self._spawn_lock
        self.spawn_errors: Dict[str, str] = _BoundedErrors(
            self._max_spawn_errors)
        self._frontend_kwargs = dict(frontend_kwargs or {})
        self.frontend: Optional[ServingFrontend] = None
        self.autoscaler: Optional[FleetAutoscaler] = None
        self.warm_pool: Optional[WarmPool] = None
        self._rpc_inited = False
        # from here on every failure funnels through shutdown() so the
        # just-started KVServer (thread + port) cannot leak — init_rpc
        # itself raises when this process already has an rpc session
        try:
            rpc.init_rpc("fleet-frontend", rank=0, world_size=1,
                         master_endpoint=master_endpoint)
            self._rpc_inited = True
            names = [self._launch() for _ in range(num_workers)]
            for name in names:
                self._await_worker(name)
        except Exception:
            self.shutdown()
            raise
        if autoscaler_policy is not None:
            self.autoscaler = FleetAutoscaler(self, autoscaler_policy)
        if warm_pool_size > 0:
            # warm-worker pool: start the first refill now so
            # the boots overlap initial serving; step() keeps it topped up
            self.warm_pool = WarmPool(warm_pool_size, self._spawn_warm,
                                      breaker=self.spawn_breaker,
                                      fault_injector=self._faults)
            self.warm_pool.refill()

    # ------------------------------------------------------- worker launch
    def _worker_script(self) -> str:
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        return os.path.join(here, "tools", "serving_worker.py")

    def _launch(self, name: Optional[str] = None,
                role: Optional[str] = None, warm: bool = False) -> str:
        """Start a worker process (non-blocking); pair with _await_worker.
        ``warm=True`` boots a pool worker: it pre-runs its programs
        BEFORE registering and parks behind a ``/serving/warm/`` marker
        (claimed by ``WarmPool``, invisible to discovery until then)."""
        if name is None:
            idx = self._next_worker
            name = f"worker{idx}"
            self._next_worker += 1
            if role is None and idx < len(self.worker_roles):
                role = self.worker_roles[idx]
        spec = dict(self.worker_spec)
        if role is not None:
            spec["role"] = role
        cmd = [sys.executable, self._worker_script(),
               "--master", self.master_endpoint, "--name", name,
               "--spec-json", json.dumps(spec)]
        if warm:
            cmd += ["--warm"]
        env = None
        if self.cpu_workers:
            cmd += ["--device", "cpu"]
            env = dict(os.environ)
            env.setdefault("OMP_NUM_THREADS", "1")
        # stderr to a file, not a pipe: nobody drains worker pipes and a
        # chatty worker (warnings) would block on a full pipe buffer
        log = tempfile.NamedTemporaryFile(
            mode="w+", prefix=f"paddle_tpu_{name}_", suffix=".log",
            delete=False)
        self._logs[name] = log.name
        self._procs[name] = subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
        log.close()
        return name

    def worker_log(self, name: str, tail: int = 2000) -> str:
        """The end of worker ``name``'s output: its log file while it is
        attached, the kept end of it once the worker was reaped (its
        ``WORKER_EXIT`` line included)."""
        path = self._logs.get(name)
        if not path or not os.path.exists(path):
            return self._final_logs.get(name, "")[-tail:]
        with open(path) as f:
            return f.read()[-tail:]

    def _await_registration(self, name: str):
        """Block until ``name`` registers with the KV master (raising, and
        reaping the process, on early exit or timeout)."""
        proc = self._procs[name]
        if self._faults is not None:
            try:
                self._faults.fire("fleet.spawn", detail=name)
            except Exception:
                # the injected spawn fault must leave no zombie behind —
                # same reap discipline as the real early-exit path below
                proc.kill()
                proc.wait(timeout=10)
                self._procs.pop(name, None)
                self._drop_log(name)
                raise
        # real wall clock, NOT the injectable self._clock: this loop
        # actually sleeps, and a frozen/jumping test clock would make the
        # spawn deadline never (or spuriously) fire
        # graft-lint: disable=determinism — see above: boot deadline on a
        # real subprocess, never replayed
        deadline = time.monotonic() + self.spawn_timeout
        while self._kv.get(f"/rpc/workers/{name}") is None:
            if proc.poll() is not None:
                err = self.worker_log(name)
                self._procs.pop(name, None)
                self._drop_log(name)
                raise RuntimeError(
                    f"serving worker '{name}' exited rc={proc.returncode} "
                    f"before registering:\n{err}")
            # graft-lint: disable=determinism — same real boot deadline
            if time.monotonic() > deadline:
                proc.kill()
                proc.wait(timeout=10)  # reap — no zombie behind the raise
                self._procs.pop(name, None)
                self._drop_log(name)
                raise TimeoutError(
                    f"serving worker '{name}' did not register within "
                    f"{self.spawn_timeout}s")
            time.sleep(0.05)

    def _await_worker(self, name: str):
        """Block until ``name`` registers with the KV master, then attach
        its RemoteReplica to the frontend."""
        self._await_registration(name)
        self._rpc.refresh_workers()
        self.attach_worker(name)

    def _make_replica(self, name: str):
        """RemoteReplica factory (constructing one IS the readiness probe:
        its ``__init__`` round-trips the worker's health RPC).  Split out
        so tests can stand in a fake replica without subprocess boots."""
        return RemoteReplica(name, rpc_timeout=self.rpc_timeout)

    def _inc_metric(self, name: str, n: int = 1):
        """Fleet-layer counter increments land in the frontend registry
        (the one the Prometheus fleet page exports under the 'frontend'
        replica label); dropped silently before the first worker attaches
        — there is no registry to count into yet."""
        if self.frontend is not None:
            self.frontend.metrics.inc(name, n)

    def _note_spawn_failure(self, name: str, err: str):
        """Shared bookkeeping for every spawn-path fault (blocking spawn,
        async boot thread, early worker death): bounded error ring,
        breaker failure, counter.  Runs on the control thread (blocking
        ``spawn_worker``) AND on async boot threads (``_spawn_wait``)
        [lock-discipline]: the error ring takes the spawn lock (callers
        must NOT already hold it); the breaker locks itself, and its
        record_failure returns the open transition atomically so two
        racing reporters cannot double-count ``breaker_open_total``."""
        with self._spawn_lock:
            self.spawn_errors[name] = err
        if self.spawn_breaker.record_failure():
            self._inc_metric("breaker_open_total")
        self._inc_metric("spawn_failures_total")

    def _attach_replica(self, replica):
        # NOT a breaker success yet: a crash-looping config usually boots
        # and attaches fine, then dies on first real work — success is
        # recorded only when the replica SURVIVES early_death_s (the
        # maturation sweep in step()), so attach/die cycles accumulate
        # failures instead of resetting the window every boot
        name = getattr(replica, "worker", None)
        if name is not None:
            self._attached_at[name] = self._clock()
        if self.frontend is None:
            self.frontend = ServingFrontend([replica],
                                            **self._frontend_kwargs)
        else:
            self.frontend.add_replica(replica)
        return replica

    def attach_worker(self, name: str):
        """Wrap an already-registered worker (spawned here or started by an
        operator on another host) in a RemoteReplica and route to it."""
        self._rpc.refresh_workers()
        return self._attach_replica(self._make_replica(name))

    def spawn_worker(self, name: Optional[str] = None,
                     role: Optional[str] = None) -> str:
        """Launch + register + attach one new worker.  Blocking: the
        worker is routable when this returns (initial fleet bring-up; the
        autoscaler's in-loop scale-up uses ``spawn_worker_async``)."""
        # only forward role= when asked: tests monkeypatch _launch with
        # role-unaware fakes, and the default path must keep working
        name = (self._launch(name, role=role) if role is not None
                else self._launch(name))
        try:
            self._await_worker(name)
        except Exception as e:  # noqa: BLE001 — feed the respawn breaker
            self._note_spawn_failure(name, repr(e))
            raise
        return name

    def spawn_worker_async(self, name: Optional[str] = None) -> str:
        """Non-blocking scale-up: launch the worker process and return its
        name immediately.  A daemon thread waits out KV registration and
        the first health probe (the torch-import + model-build boot that
        would otherwise stall the step loop), then parks the ready
        RemoteReplica;
        the next ``step()`` attaches it on the control thread.  Spawn
        failures are recorded in ``spawn_errors`` (the autoscaler's
        pending count drops either way, so it can try again).

        With a warm pool armed, a ready warm worker is claimed
        INSTEAD of launching cold: the worker already booted and warmed,
        so "spawn" collapses to one health probe and the replica attaches
        on the next step — near-zero time-to-capacity.  The pool refills
        asynchronously behind the claim; an empty pool (or a faulted
        ``pool.attach``) falls through to the cold path unchanged."""
        if name is None and self.warm_pool is not None:
            if self.warm_pool.metrics is None and self.frontend is not None:
                # a claim can precede the first control-loop step — bind
                # the pool's counters now so the attach is not invisible
                self.warm_pool.metrics = self.frontend.metrics
            claimed = self.warm_pool.claim()
            if claimed is not None:
                wname = claimed[0]
                # claimed: drop the warm marker so discovery treats it as
                # a normal worker from here on (recovery must see it)
                self._kv.delete(f"/serving/warm/{wname}")
                t = threading.Thread(target=self._adopt_warm, args=(wname,),
                                     name=f"fleet-adopt-{wname}", daemon=True)
                with self._spawn_lock:
                    self._pending_spawns[wname] = t
                t.start()
                self.warm_pool.refill()
                return wname
        name = self._launch(name)
        t = threading.Thread(target=self._spawn_wait, args=(name,),
                             name=f"fleet-spawn-{name}", daemon=True)
        with self._spawn_lock:
            self._pending_spawns[name] = t
        t.start()
        return name

    def _spawn_wait(self, name: str):
        try:
            self._await_registration(name)
            self._rpc.refresh_workers()
            replica = self._make_replica(name)
        except Exception as e:  # noqa: BLE001 — boot fault, record + reap
            # failure first, seat second: the autoscaler must never
            # observe the seat free without the failure recorded (it
            # would spawn a doomed extra worker past max_workers)
            self._note_spawn_failure(name, repr(e))  # takes _spawn_lock
            with self._spawn_lock:
                self._pending_spawns.pop(name, None)
            proc = self._procs.pop(name, None)
            if proc is not None:
                try:
                    if proc.poll() is None:
                        proc.kill()
                    proc.wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    pass   # reaped at shutdown() if truly unkillable
                self._drop_log(name)
            return
        with self._spawn_lock:
            # the _pending_spawns seat is NOT released here: it must hold
            # until the replica is actually attached, or the autoscaler
            # could observe in the ready-but-unattached window and spawn
            # past max_workers
            self._ready_replicas.append((name, replica))

    # ----------------------------------------------------- warm pool hooks
    def _spawn_warm(self, name: str):
        """``WarmPool`` spawn hook: launch a ``--warm`` worker and wait
        out its (pre-compiling) boot on a daemon thread; the pool's
        pending seat holds until ``note_ready``/``note_failed``.
        Returns None — the async contract of ``WarmPool.spawn_fn``."""
        self._launch(name, warm=True)
        t = threading.Thread(target=self._warm_wait, args=(name,),
                             name=f"fleet-warm-{name}", daemon=True)
        t.start()
        return None

    def _warm_wait(self, name: str):
        try:
            self._await_registration(name)
        except Exception as e:  # noqa: BLE001 — warm boot fault: record
            # + release the pool seat (registration already reaped the
            # process); record=False — _note_spawn_failure feeds the
            # breaker, the pool must not count the same death twice
            self._note_spawn_failure(name, repr(e))
            if self.warm_pool is not None:
                self.warm_pool.note_failed(name, record=False)
            return
        if self.warm_pool is None or not self.warm_pool.note_ready(name):
            # pool generation moved on while this worker booted (weights
            # were swapped / shutdown): it holds stale state — reap it
            # rather than ever pooling or attaching it
            self._reap_proc(name, kill=True)

    def _adopt_warm(self, name: str):
        """Attach side of a warm claim: the worker already booted and
        warmed, so all that remains is one health probe (the
        RemoteReplica constructor) — the near-zero-latency attach the
        pool exists for.  Runs on a daemon thread like ``_spawn_wait``;
        the next ``step()`` attaches the parked replica."""
        try:
            self._rpc.refresh_workers()
            replica = self._make_replica(name)
        except Exception as e:  # noqa: BLE001 — probe fault on a claimed
            # warm worker: same containment as a failed cold boot
            self._note_spawn_failure(name, repr(e))
            self._inc_metric("pool_attach_failures_total")
            with self._spawn_lock:
                self._pending_spawns.pop(name, None)
            self._reap_proc(name, kill=True)
            return
        with self._spawn_lock:
            self._ready_replicas.append((name, replica))

    def _flush_warm_pool(self):
        """Reap every READY warm worker and refill (rolling swap: pooled
        workers hold pre-swap weights and must never attach; the
        generation bump makes still-booting ones refuse pooling too)."""
        if self.warm_pool is None:
            return
        for wname, _ in self.warm_pool.drain_ready():
            self._kv.delete(f"/serving/warm/{wname}")
            self._reap_proc(wname, kill=True)
        self.warm_pool.refill()

    @property
    def num_pending_spawns(self) -> int:
        """Workers launched asynchronously but not yet attached — the
        autoscaler counts these as capacity already on the way."""
        with self._spawn_lock:
            return len(self._pending_spawns)

    def _attach_ready(self):
        """Attach replicas whose async spawn completed (control thread
        only — frontend structures are single-threaded); the pending
        seat is released only now, with the replica live."""
        with self._spawn_lock:
            ready, self._ready_replicas = self._ready_replicas, []
            for name, _ in ready:
                self._pending_spawns.pop(name, None)
        for _, replica in ready:
            self._attach_replica(replica)

    def _note_matured_replicas(self):
        """Replicas alive past ``early_death_s`` since attach count as
        spawn SUCCESSES: this is what re-closes a half-open breaker (the
        probe worker proved itself) and clears the failure window after
        genuine recovery.  Recording at attach instead would let a
        boots-fine-dies-early crash loop reset the window every cycle
        and the breaker would never open."""
        if self.frontend is None:
            return
        now = self._clock()
        for rep in self.frontend.replicas:
            if not rep.alive:
                continue
            name = getattr(rep.engine, "worker", None)
            att = self._attached_at.get(name) if name is not None else None
            if att is not None and now - att >= self.early_death_s:
                self._attached_at.pop(name, None)
                self.spawn_breaker.record_success()

    # ------------------------------------------------------------- driving
    @property
    def workers(self) -> List[str]:
        if self.frontend is None:
            return []
        return [r.engine.worker for r in self.frontend.replicas
                if isinstance(r.engine, RemoteReplica)]

    def _require_frontend(self) -> ServingFrontend:
        if self.frontend is None:
            raise RuntimeError(
                "ServingFleet has no workers yet (num_workers=0 and nothing "
                "attached) — spawn_worker()/attach_worker() first")
        return self.frontend

    def step(self):
        """One fleet iteration: attach async-spawned replicas, heartbeat
        (rate-limited), autoscale (if attached), frontend step, reap
        drained/dead workers."""
        self._attach_ready()
        fe = self._require_frontend()
        self._note_matured_replicas()
        now = self._clock()
        if now - self._last_heartbeat >= self.heartbeat_interval_s:
            self._last_heartbeat = now
            self.heartbeat()
        if self.autoscaler is not None:
            self.autoscaler.observe()
        fe.metrics.set_gauge("respawn_breaker_open",
                             self.spawn_breaker.open_gauge)
        if self.warm_pool is not None:
            # bind the pool's counters to the frontend registry (it may
            # not have existed at pool creation) and keep it topped up —
            # refill is a no-op depth check when the pool is full
            if self.warm_pool.metrics is None:
                self.warm_pool.metrics = fe.metrics
            self.warm_pool.refill()
            fe.metrics.set_gauge("warm_pool_depth", self.warm_pool.depth())
        fe.step()
        self._reap()

    def run(self, max_steps: int = 10_000):
        """Drive ``step()`` until every submitted request has a result
        (same contract/failure mode as ``ServingFrontend.run``)."""
        fe = self._require_frontend()
        for _ in range(max_steps):
            if not fe.pending:
                break
            self.step()
        if fe.pending:
            raise RuntimeError(
                f"ServingFleet.run: max_steps={max_steps} exhausted with "
                f"{fe.pending} unresolved request(s)")
        return fe.results()

    def heartbeat(self):
        """Probe every live replica's health RPC; a silent worker (probe
        raises — SIGKILLed process, or a hung handler past the SHORT
        ``heartbeat_timeout_s``, so detection is bounded by roughly one
        interval rather than the 60 s data-plane deadline) is failed over
        exactly like a step() fault: marked dead, in-flight requests
        re-queued from frontend-side state."""
        if self.frontend is None:
            return
        for rep in self.frontend.replicas:
            if not rep.alive or not isinstance(rep.engine, RemoteReplica):
                continue
            try:
                if self._faults is not None:
                    self._faults.fire("fleet.heartbeat",
                                      detail=rep.engine.worker)
                # transient-fault retry: the probe is idempotent, so one
                # dropped/slow packet re-probes instead of failing over a
                # healthy worker (a genuinely dead one fails every retry
                # and still dies within this heartbeat)
                rep.engine.health(timeout=self.heartbeat_timeout_s,
                                  retries=self.heartbeat_retries)
            except Exception as e:  # noqa: BLE001 — any probe fault = dead
                self.frontend.fail_replica(rep, e)

    # ------------------------------------------------------------- swapping
    def rolling_swap(self, spec: Dict, version: str, *,
                     model_id: Optional[str] = None,
                     max_steps: int = 10_000) -> int:
        """Fleet-wide zero-downtime weight swap: one replica
        at a time, drain → ``_w_swap_weights`` (the worker rebuilds the
        seeded weights from ``spec`` — the worker-spec recipe, nothing
        tensor-sized on the wire) → re-admit.  Drives ``self.step`` while
        draining so heartbeats, autoscaling, and warm-pool maintenance
        keep running.  On success the fleet's own ``worker_spec`` is
        updated too, so respawned workers and future warm boots come up
        on the NEW version instead of silently rolling back; the warm
        pool's pre-swap workers are reaped and the pool refilled.
        Returns the number of replicas now serving ``version``."""
        fe = self._require_frontend()
        n = fe.rolling_swap(spec, version, model_id=model_id,
                            step=self.step, max_steps=max_steps)
        if n:
            for key in ("seed", "model", "bfloat16", "numpy_state"):
                if key in spec:
                    self.worker_spec[key] = spec[key]
            # respawns must come up LABELLED as the new version, not v0
            self.worker_spec["weights_version"] = version
            if model_id is not None:
                self.worker_spec["model_id"] = model_id
            self._flush_warm_pool()
        return n

    # ------------------------------------------------------------ draining
    def drain_replica(self, rep):
        """Begin scale-down of one replica: stop admitting to it; once its
        in-flight work finishes, ``step()`` deregisters the worker and
        reaps the process."""
        rep.draining = True

    def _reap(self):
        for rep in list(self.frontend.replicas):
            if not isinstance(rep.engine, RemoteReplica):
                continue
            name = rep.engine.worker
            if getattr(rep, "swapping", False):
                # drained-for-swap, not scale-down: the swap
                # driver re-admits this replica — reaping it here would
                # turn every rolling swap into a worker funeral
                continue
            if rep.alive and rep.draining and not rep.requests \
                    and not rep.engine._queue and not rep.engine._active:
                try:
                    # a drained worker is idle; the short probe timeout is
                    # the right bound (a wedged one just gets SIGKILLed)
                    rep.engine.request_shutdown(self.heartbeat_timeout_s)
                # graft-lint: disable=typed-termination — best-effort
                # polite stop; _reap_proc below SIGTERM/SIGKILLs anyway
                except Exception:  # noqa: BLE001
                    pass
                self._attached_at.pop(name, None)   # drained, not dead
                self.frontend.remove_replica(rep)
                self._reap_proc(name)
            elif not rep.alive:
                # failover already re-queued its requests; deregister
                att = self._attached_at.pop(name, None)
                if (att is not None
                        and self._clock() - att < self.early_death_s):
                    # spawn-or-early-death: a worker that dies this soon
                    # after attaching counts against the respawn breaker
                    # exactly like a failed spawn — a crash-looping config
                    # usually boots fine and dies on first real work
                    self._note_spawn_failure(
                        name, f"early death: replica died within "
                        f"{self.early_death_s}s of attach "
                        f"({rep.last_error})")
                self.frontend.remove_replica(rep)
                self._reap_proc(name, kill=True)

    def _reap_proc(self, name: str, kill: bool = False, timeout: float = 30):
        # the KV deregistration must happen even for externally-attached
        # workers (no local Popen): a stale /rpc/workers entry would keep
        # a dead worker in everyone's routing table on the next refresh
        self._kv.delete(f"/rpc/workers/{name}")
        self._kv.delete(f"/serving/roles/{name}")  # role label rides along
        self._kv.delete(f"/serving/wire/{name}")   # data-plane endpoint too
        proc = self._procs.pop(name, None)
        if proc is None:
            return
        try:
            if kill and proc.poll() is None:
                proc.kill()
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        self._drop_log(name)

    def _drop_log(self, name: str):
        path = self._logs.pop(name, None)
        if path:
            try:
                with open(path) as f:
                    self._final_logs[name] = f.read()[-(64 << 10):]
                os.unlink(path)
            except OSError:
                pass

    # ------------------------------------------------------------- metrics
    def worker_snapshots(self, include_samples: bool = True) -> Dict[str, Dict]:
        """{worker_name: metrics snapshot} from every reachable replica."""
        out: Dict[str, Dict] = {}
        for rep in self.frontend.replicas:
            if not rep.alive or not isinstance(rep.engine, RemoteReplica):
                continue
            try:
                out[rep.engine.worker] = \
                    rep.engine.health(include_samples)["metrics"]
            # graft-lint: disable=typed-termination — scrape path: a
            # worker that cannot answer is simply absent from this page;
            # the heartbeat (not the scraper) owns declaring it dead
            except Exception:  # noqa: BLE001
                pass
        return out

    def reset_worker_metrics(self):
        """Zero every reachable worker's registry (pair with
        ``frontend.metrics.reset()`` when excluding a warmup window)."""
        for rep in self.frontend.replicas:
            if not rep.alive or not isinstance(rep.engine, RemoteReplica):
                continue
            try:
                self._rpc.rpc_sync(rep.engine.worker, _w_reset_metrics,
                                   kwargs={"epoch": rep.engine._epoch},
                                   timeout=rep.engine.rpc_timeout)
            # graft-lint: disable=typed-termination — warmup-window reset
            # is advisory; an unreachable worker keeps its counters and
            # the heartbeat owns its fate
            except Exception:  # noqa: BLE001
                pass

    def merged_snapshot(self) -> Dict:
        """One fleet-wide engine-level snapshot (ServingMetrics.merge of
        the per-worker registries).  Request-level metrics (TTFT, e2e,
        admission counters) live in ``self.frontend.metrics`` — the two
        views count different things, so they are not summed together."""
        return ServingMetrics.merge(self.worker_snapshots())

    def prometheus_text(self) -> str:
        """One scrape page: every worker's engine-level series plus the
        frontend's request-level series, each with a ``replica`` label.
        Rendering only reads the precomputed quantile summaries, so the
        raw sample buffers (up to ~1.5 MB pickled per worker) stay out of
        the per-scrape RPCs — ``merged_snapshot`` is the path that needs
        them for exact fleet-wide percentiles."""
        snaps = dict(self.worker_snapshots(include_samples=False))
        snaps["frontend"] = self.frontend.metrics.snapshot()
        return ServingMetrics.prometheus_text_fleet(snaps)

    # ------------------------------------------------------------ shutdown
    def shutdown(self):
        """Stop every worker (polite RPC first, then kill), the RPC state,
        and the KV master.  Idempotent."""
        if self.warm_pool is not None:
            # stop refills first, then drop the warm markers (best
            # effort: the KV master may already be gone); the pooled
            # processes are in self._procs and die with everyone below
            self.warm_pool.size = 0
            for wname, _ in self.warm_pool.drain_ready():
                try:
                    self._kv.delete(f"/serving/warm/{wname}")
                # graft-lint: disable=typed-termination — best-effort
                # marker cleanup during teardown
                except Exception:  # noqa: BLE001
                    pass
        if self.frontend is not None:
            for rep in self.frontend.replicas:
                if rep.alive and isinstance(rep.engine, RemoteReplica):
                    try:
                        # heartbeat timeout, not the 60 s data-plane one: a
                        # hung worker must not stall shutdown per replica
                        rep.engine.request_shutdown(self.heartbeat_timeout_s)
                    # graft-lint: disable=typed-termination — best-effort
                    # polite stop during shutdown; SIGTERM/SIGKILL follow
                    except Exception:  # noqa: BLE001
                        pass
        for name, proc in list(self._procs.items()):
            # SIGTERM (the worker installs a handler that sets its stop
            # event) covers workers that never got the polite RPC — e.g.
            # a spawn that timed out mid-__init__ — without the 15 s stall
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
            self._procs.pop(name, None)
            self._drop_log(name)
        if self._rpc_inited:
            # only tear down the rpc session THIS fleet created — when
            # init_rpc refused because the process already had one (e.g. a
            # concurrent fleet), that session belongs to someone else
            self._rpc.shutdown()
            self._rpc_inited = False
        if self._kv_server is not None:
            self._kv_server.stop()
            self._kv_server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
