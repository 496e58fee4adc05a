"""SLO-aware serving control plane: the layer between callers and one or
more ``ServingEngine`` replicas (reference analogs: fleet's elastic
manager for replica health, Orca-style iteration-level scheduling for the
dispatch loop, vLLM-style recompute preemption for block-pool pressure —
adapted to the static-shape regime of the engine's CUDA graphs).

Copied from ``paddle_tpu/inference/control_plane.py`` (the port never
imports the JAX package) over the port's ``ServingEngine``: the frontend
drives ``ServingEngine.step()``, whose programs run the port's kernels
(on CUDA graphs on the card); ``from_model`` builds its engines on the
model's device unless ``device=`` says otherwise.

``ServingFrontend`` owns the request lifecycle end to end; the engines
stay pure execution loops driven via ``ServingEngine.step()``:

* **Admission** — a priority queue (``Priority.HIGH/NORMAL/LOW``) with
  per-request deadlines and token-budget-aware caps.  A request that can
  never fit, or that arrives past the configured queue caps, resolves
  immediately with a typed ``OVERLOADED`` result — submit never blocks.
* **Deadlines & cancellation** — queued requests past deadline are shed
  (``DEADLINE_EXCEEDED``); running ones are evicted mid-generation and
  return their partial tokens.  ``cancel(rid)`` works in both states.
  MEGASTEP BOUNDARY SEMANTICS: the
  engines decode up to ``megastep_k`` (K) tokens per compiled step and
  the frontend's deadline/cancel checks run between steps, but the
  deadline no longer overshoots by up to K-1 tokens: at dispatch the
  frontend forwards the REMAINING deadline (``deadline_s``) to the
  engine, which converts it into a per-row iteration budget carried as
  data through the scan and decremented in-graph — a row whose budget
  hits zero freezes mid-scan and emits nothing further, so token
  overshoot is ZERO once the engine has a per-iteration time estimate
  (EWMA of measured megastep time, or an injected
  ``deadline_token_seconds``).  The frontend's boundary check is still
  what finalizes the typed ``DEADLINE_EXCEEDED`` shed, carrying every
  token generated before the freeze.  Before the first measured
  megastep the engine has no estimate and the old K-1 bound is the
  worst case; cancellation (which has no in-graph analog) still
  resolves at the next boundary.
* **Sampling & streaming** — ``submit`` takes per-request
  ``temperature``/``top_k``/``top_p``/``seed``/``logprobs`` (defaults =
  exact greedy argmax; see ``serving.SamplingParams``) and forwards them
  to the engine's in-graph sampler; seeded streams replay identically
  across preemption, failover, and worker restarts because the PRNG key
  depends only on (seed, sample index).  Tokens are surfaced
  incrementally: pass ``on_token=fn`` to ``submit`` (called
  ``fn(rid, token)`` per token as each engine step is harvested — i.e.
  in bursts of up to K at megastep boundaries) or drive
  ``stream(rid)``, an iterator that steps the frontend and yields the
  request's tokens in order until its terminal result.
* **Recompute preemption** — when a request cannot be placed because the
  block pools are exhausted, the lowest-priority (then youngest) running
  sequence strictly below the waiting request's class is evicted via
  ``ServingEngine.evict``: its blocks are freed and it is re-queued with
  ``prompt + generated`` as the new prefill.  Greedy decode is
  deterministic, so a preempted-then-resumed request produces exactly
  the tokens of an unpreempted run.
* **Routing & failover** — prefix-affinity placement first: the prompt's
  full-block chain hashes are scored against each replica's cached-block
  summary (mirrored from ``state_summary`` for remote replicas) and the
  live, non-draining replica with the longest cached prefix wins, so
  shared-system-prompt traffic lands where its KV already is; ties fall
  back to the least-loaded rule with round-robin tie-break.  A replica
  whose ``step()`` raises is
  marked dead; its in-flight requests are re-queued from host-side state
  (prompt + tokens harvested so far) and drained to survivors.  With no
  survivors, every pending request resolves with a typed ``FAILED``
  result — nothing is silently dropped.
* **Retry budgets & poison quarantine** — every replica death charges
  the in-flight requests' ``attempts``; one that outlives
  ``max_request_retries`` deaths (whether the replica died mid-step or
  at dispatch) resolves typed ``FAILED_POISON`` instead of being handed
  to — and likely killing — the next replica.  The failure mode this
  contains: one deterministically-crashing request cascading through
  every replica in the fleet.
* **Brownout degradation** — with a ``BrownoutPolicy``, sustained
  queue/pool pressure first sheds LOW admission (typed
  ``REJECTED_BROWNOUT``), then caps NORMAL ``max_new_tokens``; HIGH is
  never degraded.  Enter/exit thresholds are split (a hysteresis band)
  and each transition needs consecutive pressured/clear control steps,
  so the level — exported as the ``degraded_mode`` gauge — moves only on
  sustained signals and restores automatically.
* **Metrics** — a ``ServingMetrics`` registry sampled inside the step
  loop (TTFT, per-token latency, tokens/s, queue depth, shed/preempt
  counters, block-pool utilization) with ``snapshot()`` and a
  Prometheus-text export.

Durability.  Pass ``journal=RequestJournal(path)`` and the
frontend write-ahead-journals the request LIFECYCLE: an ``admit`` record
(prompt ids, ``SamplingParams`` wire dict, priority/deadline/budget
fields, idempotency key) lands before the request can reach a replica, a
``progress`` record at each megastep boundary that harvested tokens, and
exactly one typed ``terminal`` record from ``_finish``.  What is NOT
journaled: the tokens.  They don't need to be — greedy decode is
deterministic and sampled streams depend only on ``(seed, sample
index)``, so a recovered request re-prefilled from its journaled prompt
provably reproduces the crash-free token stream.  ``recover(journal,
engines)`` rebuilds a frontend after a crash: it reaps orphaned
sequences the dead frontend left on still-live engines/workers
(``reap_orphans``, over RPC for ``RemoteReplica``), re-admits every
journaled request without a terminal record as fresh prefill (deadlines
re-arm with their remaining budget), restores the idempotency map, and
compacts the journal to a snapshot before serving resumes.
``submit(..., idempotency_key=...)`` dedupes client retries — including
retries that straddle the restart — against a bounded terminal-result
cache, so "exactly one typed terminal status per admitted request"
survives frontend death plus client redelivery.  Journal I/O faults
(their ``journal.append``/``journal.fsync`` failpoints included) NEVER
kill serving: the frontend degrades to non-durable mode and raises the
``journal_degraded`` gauge loudly instead.

Leadership & fencing.  Recovery alone is a manual,
single-incarnation story; the HA layer (``inference/ha.py``) makes it
automatic and zombie-safe:

* **Lease** — pass ``lease=FrontendLease(master_endpoint)`` (acquired)
  and the frontend renews it inside ``step()`` (ttl/3 cadence).  The
  lease guarantees exactly one holder *as the KV master sees it* and
  arbitrates who gets the next epoch — it does NOT by itself stop a
  paused-then-resumed zombie, which cannot observe its own expiry.
* **Epoch fencing** — the frontend's ``epoch`` (from the lease, or
  explicit) rides every control RPC; workers/``FencedEngine`` wrappers
  remember the highest epoch seen and reject lower ones with the typed
  ``StaleEpoch``.  A ``StaleEpoch`` from any replica is TERMINAL for
  this frontend: it marks itself deposed, stops journaling (the file
  belongs to the successor), and re-raises — never treated as a
  replica fault, never re-queued (the new incarnation already owns the
  requests; re-queueing would double-execute them).  Losing the lease
  at renew time deposes the same way, before any worker RPC is wasted.
  The journal FILE is fenced too: RPC epochs cannot see file writes,
  so the journal tracks the inode it owns (a successor's recovery
  compaction installs a new one) and a stale writer's append/compaction
  raises ``JournalSuperseded`` — surfaced as the same typed deposition
  — instead of clobbering the successor's WAL.
* **Takeover** — a ``StandbyFrontend`` watches the lease; on expiry it
  acquires at epoch+1 and runs ``recover`` — whose orphan reap is the
  FIRST rpc of the new epoch, so the workers fence every older
  incarnation out before any request is re-admitted.  ``recover``
  refuses a journal recorded by a HIGHER epoch (the caller is the
  stale one) and, given no explicit epoch, arms at journal epoch + 1.
* **Handoff** — ``handoff()`` is the rolling-upgrade path: stop
  admitting, flush the buffered terminal group-commit, write a final
  compaction snapshot (through the ``handoff.flush`` failpoint),
  release the lease EARLY, and stop.  The successor recovers with zero
  dropped admitted requests and the idempotency map intact, and no
  ``StaleEpoch`` fires anywhere — a clean handoff never manufactures a
  zombie.

Epoch semantics: epochs are integers, monotone across incarnations
forever (release preserves the counter); ``epoch=None`` disables
fencing entirely (pre-HA single-frontend deployments).  Rid spaces:
admitted requests draw non-negative rids journaled with a high-water
mark; synchronous typed rejections draw NEGATIVE rids from a separate,
never-journaled space — so a recovered frontend can never re-issue a
rid a pre-crash client saw, journaled or not.

Frontend → fleet → engine split: a replica is anything exposing the
ServingEngine driving surface — an in-process engine or a
``fleet.RemoteReplica`` proxy whose engine lives in a
``tools/serving_worker.py`` process (spawnable on another host) behind
the ``distributed/rpc`` stack.  Because the frontend owns all admission
state, caps like ``class_token_budgets`` hold fleet-wide no matter how
many replicas exist; ``fleet.ServingFleet`` adds worker spawn/drain,
heartbeat health-checking (via ``fail_replica``), autoscaling, and
fleet-wide metrics aggregation on top of this class, and replicas can be
attached/detached at runtime with ``add_replica``/``remove_replica``
(``draining`` replicas finish in-flight work but take no new
placements).

Tracing.  Pass ``tracer=tracing.Tracer(...)`` and every
admitted request gets a deterministic ``TraceContext`` whose id rides
the journal admit record (a recovered request keeps its trace) and
whose per-dispatch ``attempt-N`` child span is stamped onto the engine
RPC like ``epoch=`` — workers record against it and ship their events
back on the ``_w_step`` reply, so ``tracer`` assembles ONE fleet-wide
span tree per request.  What IS recorded: admission (``admit``/
``queue``), every dispatch (``dispatch`` on the attempt span), prefill
completion and each megastep boundary with its token count (engine
side), ``preempt``/``retry``/``replica_death``/``recover`` lifecycle
edges, exactly one typed ``terminal`` per request, and trace-less
process events for lease renew/depose/fence/takeover/handoff, brownout
level moves, breaker transitions, and fault-injection fires.  What is
NOT recorded: tokens, prompts (only lengths), logprobs, raw exception
text on span events, or anything inside a compiled body — tracing is
host-side only, bounded (flight-recorder ring + per-trace index), and
zero-cost when ``tracer`` is None.  TTFT/ITL/e2e histogram
observations carry the trace id as an exemplar
(``metrics.exemplars``), so a latency outlier is one lookup from its
tree; non-COMPLETED terminals and slow completions auto-capture their
trees into ``tracer.captures``.

Disaggregation.  Pass ``kv_fabric=KVFabric(master)`` and
label replicas with roles (``ServingFleet(worker_roles=...)`` or
``engine.role = "prefill"``) to split the fleet: prefill-role replicas
run prompts as one-token *prefill passes* (the sampled token is
discarded; decode re-emits it token-identically because the seeded
sample stream restarts at offset 0), publish the prompt's full-block
chain into the fleet-wide directory, and stream the KV payloads to the
decode replica that will own the request.  Decode admission consults
the directory before computing any prefix: a chain published anywhere
in the fleet is pulled instead of recomputed, and a *prefill-in-
progress* table dedupes concurrent identical prompts down to one pass.
What the directory GUARANTEES: every entry is stamped with its writer's
fencing epoch (an entry IS a fenced block lease — a deposed frontend's
entries surface as typed ``StaleEpoch`` and are dropped, never served);
payload transfer is bit-exact (``cache_quant='int8'`` caches are a
typed error — per-slot dynamic scales make their payloads
writer-specific); served tokens are identical to colocated serving,
greedy and seeded.  What it does NOT guarantee: that an entry's blocks
still exist (the owner may have died or evicted them — every fabric
fault, including all three ``fabric.*`` failpoints, degrades to
recomputing the prefix locally), that a chain is transferred at most
once, or any durability (the directory is a routing hint over the
launch KV master, not a replicated store; losing it costs recompute,
never correctness).  One request burns at most one prefill pass
(``prefill_passes`` budget): a fabric sick enough to fail the pass
falls back to classic colocated placement.

Tenancy.  Pass ``tenants=TenantRegistry([...])`` and the one
fleet serves N tenants — named traffic classes each owning a model (or
adapter) id, an admission token budget, a priority ceiling, and a
fairness weight.  Admission: a tenant's requests are clamped to its
priority ceiling and typed-rejected (OVERLOADED,
``tenant_rejected_budget_total``) once its OUTSTANDING admitted tokens
(prompt + max_new, released at terminal) exceed its budget — a bursty
tenant cannot starve a steady one past its contract.  Fairness
contract: dispatch runs deficit round-robin ACROSS tenants above the
priority classes — each round credits every backlogged tenant
``quantum * weight`` deficit tokens and places its (priority-sorted)
requests while their remaining-token cost fits the credit, so over any
window where two tenants stay backlogged their served-token shares
converge to the ratio of their weights, independent of request sizes;
priorities still order work WITHIN a tenant, and a tenant whose queue
drains forfeits unused credit (no banking bursts).  Routing: a
tenant's requests prefer replicas whose ``engine.model_id`` matches
its model; with ``TenantRegistry.model_provider`` armed, a mismatched
fleet swaps a replica on demand (an idle one immediately, else the
least-loaded one is drained for the swap) — without a provider the
model id is a preference, never a wedge.

Rolling weight swaps.  ``rolling_swap(new_weights, version)`` upgrades
the fleet one replica at a time: drain → ``engine.load_weights`` →
re-admit.  What a swap GUARANTEES: zero dropped admitted requests
(draining replicas finish their in-flight work; queued work routes to
the rest of the fleet), and greedy+seeded token parity for every
request completing entirely on ONE weights version — a drained replica
has no in-flight sequence when its weights change, and the swap
invalidates the replica's prefix cache and fabric directory entries,
so no new-version request decodes against old-version KV.  What it
does NOT guarantee: which version a mid-roll request lands on
(``RequestResult.weights_version`` reports the version that generated
its final tokens), fleet-wide atomicity (mid-roll the fleet is
mixed-version by design), or admission continuity on a ONE-replica
fleet (while its only replica drains, new submits take the typed
draining rejection).  A swap fault (the ``weights.swap`` failpoint)
leaves the replica serving its OLD version — counted in
``weight_swap_failures_total``, never a drop.  Per-tenant counters and
the ``weights_version`` trace/result labels ride the existing metric
and trace machinery.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from enum import Enum, IntEnum
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .ha import HANDOFF_FLUSH, FrontendLease, StaleEpoch
from .journal import (ADMIT, EPOCH, PROGRESS, TERMINAL, JournalSuperseded,
                      RequestJournal)
from .metrics import (MEGASTEP_COUNTERS, SPEC_COUNTERS, ServingMetrics,
                      fold_counter_deltas, fold_prefix_counters)
from .serving import SamplingParams, ServingEngine, prompt_block_hashes
from .tenancy import TenantRegistry
from .tracing import TraceContext, Tracer

__all__ = ["Priority", "RequestStatus", "RequestResult", "ServingFrontend",
           "BrownoutPolicy", "StaleEpoch", "HandedOff"]


class HandedOff(RuntimeError):
    """This frontend completed ``handoff()``: the successor owns every
    open request, so submit/cancel/step here would double-drive state
    the handoff snapshot already transferred.  Typed (rather than a
    bare RuntimeError) so callers route to the successor the same way
    :class:`~paddle_tpu_torch.inference.ha.StaleEpoch` routes a deposed
    zombie's traffic — the two are the clean and the fenced half of the
    same succession story.  Subclasses RuntimeError for compatibility
    with pre-typed callers."""


class Priority(IntEnum):
    """Lower value = more important. Preemption only ever evicts a
    strictly lower class than the request waiting for blocks."""

    HIGH = 0
    NORMAL = 1
    LOW = 2


class RequestStatus(Enum):
    COMPLETED = "completed"
    OVERLOADED = "overloaded"              # rejected at/after admission
    DEADLINE_EXCEEDED = "deadline_exceeded"  # shed from queue or mid-flight
    CANCELLED = "cancelled"
    FAILED = "failed"                      # replica death with no survivor
    # the replica serving this request died more than max_request_retries
    # times: quarantined as poison instead of cascading through the fleet
    FAILED_POISON = "failed_poison"
    # brownout degradation shed this request's class at admission
    REJECTED_BROWNOUT = "rejected_brownout"


_STATUS_COUNTER = {
    RequestStatus.COMPLETED: "completed_total",
    RequestStatus.OVERLOADED: "rejected_overloaded_total",
    RequestStatus.DEADLINE_EXCEEDED: "shed_deadline_total",
    RequestStatus.CANCELLED: "cancelled_total",
    RequestStatus.FAILED: "failed_total",
    RequestStatus.FAILED_POISON: "requests_quarantined_total",
    RequestStatus.REJECTED_BROWNOUT: "shed_brownout_total",
}


@dataclass
class BrownoutPolicy:
    """Hysteresis knobs for graceful degradation under sustained
    pressure (the analog of load-shedding tiers in front of a saturated
    service: shed the cheapest traffic first, then shrink the work
    accepted, instead of the binary admit-or-reject cliff).

    Pressure = queued requests per accepting replica above ``queue_high``
    OR live block-pool utilization above ``pool_high``, sustained for
    ``enter_after`` consecutive control steps; each sustained episode
    escalates ONE level (0 normal -> 1 shed LOW admission -> 2 also cap
    NORMAL ``max_new_tokens`` at ``normal_max_new_tokens``).  Recovery is
    the mirror image with the LOW thresholds and ``exit_after`` — the gap
    between the high and low thresholds is the hysteresis band that
    keeps the fleet from flapping at the boundary.  HIGH traffic is
    never degraded."""

    queue_high: float = 8.0   # queued per accepting replica: enter above
    queue_low: float = 2.0    # ...and only recover below this
    pool_high: float = 0.95   # block-pool utilization: enter above
    pool_low: float = 0.75
    enter_after: int = 2      # consecutive pressured steps per escalation
    exit_after: int = 4       # consecutive clear steps per de-escalation
    normal_max_new_tokens: int = 16   # level-2 cap for NORMAL requests

    def __post_init__(self):
        if self.queue_low > self.queue_high or self.pool_low > self.pool_high:
            raise ValueError(
                "BrownoutPolicy hysteresis needs low <= high thresholds "
                f"(queue {self.queue_low}/{self.queue_high}, "
                f"pool {self.pool_low}/{self.pool_high})")
        if self.normal_max_new_tokens < 1:
            raise ValueError("normal_max_new_tokens must be >= 1")


@dataclass
class RequestResult:
    """Typed terminal outcome for one submitted request. ``tokens`` holds
    whatever was generated before the terminal state (partial for
    sheds/cancels, complete for COMPLETED).  ``logprobs`` aligns 1:1 with
    ``tokens`` when the request asked for them (else None)."""

    rid: int
    status: RequestStatus
    tokens: List[int] = field(default_factory=list)
    detail: str = ""
    preemptions: int = 0
    attempts: int = 0              # replica deaths survived via re-queue
    ttft_s: Optional[float] = None
    e2e_s: Optional[float] = None
    logprobs: Optional[List[float]] = None
    # weights version that generated the FINAL harvested tokens (None =
    # version-less engine); single-version requests report that version
    weights_version: Optional[str] = None
    tenant: Optional[str] = None   # tenant attribution (registry armed)

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.COMPLETED


@dataclass(eq=False)
class _FrontendRequest:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    priority: Priority
    deadline_t: Optional[float]    # absolute clock() time, None = no SLO
    eos_token_id: Optional[int]
    submit_t: float
    seq: int                       # FIFO tie-break within a priority class
    sampling: SamplingParams = field(default_factory=SamplingParams)
    on_token: Optional[Callable[[int, int], None]] = None
    idempotency_key: Optional[str] = None
    admitted: bool = False         # past admission checks (journaled scope)
    generated: List[int] = field(default_factory=list)
    logprob_values: List[float] = field(default_factory=list)
    preemptions: int = 0
    assignments: int = 0
    attempts: int = 0              # failover re-queues (replica deaths)
    capped_from: Optional[int] = None  # brownout clipped max_new_tokens
    replica: Optional["_Replica"] = None
    engine_rid: Optional[int] = None
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    counted_tokens: int = 0        # held against the class token budget
    trace: Optional[TraceContext] = None  # root span (tracer armed only)
    # disaggregation (kv_fabric): True while the request is running as a
    # prefill PASS on a prefill-role replica — its sampled token is
    # discarded, the pass exists to compute + publish the prompt's KV
    prefill_pass: bool = False
    prefill_passes: int = 0        # passes burned (bounds retry loops)
    fabric_key: Optional[str] = None  # held prefill-in-progress claim
    # tenancy: resolved tenant name (None = registry off) and
    # the weights version stamped at each harvest — last writer wins, so
    # a single-version request reports exactly its version
    tenant: Optional[str] = None
    weights_version: Optional[str] = None

    @property
    def remaining_new_tokens(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def total_tokens(self) -> int:
        # invariant across preemptions: resumed prefill (prompt+generated)
        # plus remaining budget always sums to prompt + max_new
        return len(self.prompt) + self.max_new_tokens

    def sort_key(self):
        return (int(self.priority), self.seq)


class _Replica:
    """One engine plus the frontend's view of what runs on it.

    ``engine`` is anything with the ServingEngine driving surface
    (``add_request``/``step``/``evict``/``pop_finished`` + the capacity
    attrs) — an in-process engine or a ``fleet.RemoteReplica`` proxy.
    ``draining`` replicas take no new placements but keep stepping until
    their in-flight requests finish (fleet scale-down)."""

    def __init__(self, idx: int, engine: ServingEngine):
        self.idx = idx
        self.engine = engine
        self.alive = True
        self.draining = False
        # True while draining FOR A WEIGHT SWAP (rolling_swap or tenant
        # swap-on-demand): the fleet's scale-down reaper must leave a
        # swap-draining replica alone — it re-admits after the swap
        self.swapping = False
        self.last_error: Optional[str] = None
        self.requests: Dict[int, _FrontendRequest] = {}  # engine_rid -> req
        # engine-level counters last folded into the registry (the engine
        # counts monotonically; the frontend incs the deltas so the
        # registry counter survives replica death/removal)
        self.prefix_seen = (0, 0, 0)  # (hit_blocks, miss_blocks, evictions)
        # (megasteps, megastep tokens, mixed launches, prefill chunks) —
        # the MEGASTEP_COUNTERS wire order
        self.mega_seen = (0, 0, 0, 0)
        # (accepted, drafted, verify forwards) — the SPEC_COUNTERS wire
        # order
        self.spec_seen = (0, 0, 0)


def _blocks_needed(engine: ServingEngine, total_tokens: int) -> int:
    return (total_tokens + engine.bs - 1) // engine.bs


class ServingFrontend:
    """SLO-aware router/admission layer over ServingEngine replicas.

    >>> fe = ServingFrontend([eng_a, eng_b], max_queue_requests=64)
    >>> rid = fe.submit([1, 5, 7], max_new_tokens=16,
    ...                 priority=Priority.HIGH, deadline_s=2.0)
    >>> results = fe.run()          # {rid: RequestResult}
    >>> fe.metrics.snapshot()["tokens_per_sec"]
    """

    def __init__(self, engines: Union[ServingEngine, Sequence[ServingEngine]],
                 *, max_queue_requests: Optional[int] = None,
                 max_queue_tokens: Optional[int] = None,
                 class_token_budgets: Optional[Dict[Priority, int]] = None,
                 preemption: bool = True,
                 max_request_retries: int = 3,
                 brownout: Optional[BrownoutPolicy] = None,
                 journal: Optional[RequestJournal] = None,
                 journal_compact_every: int = 1024,
                 idempotency_cache_size: int = 4096,
                 epoch: Optional[int] = None,
                 lease: Optional[FrontendLease] = None,
                 clock: Callable[[], float] = time.monotonic,
                 metrics: Optional[ServingMetrics] = None,
                 tracer: Optional[Tracer] = None,
                 kv_fabric=None,
                 tenants: Optional[TenantRegistry] = None):
        if isinstance(engines, ServingEngine):
            engines = [engines]
        if not engines:
            raise ValueError("ServingFrontend needs at least one engine")
        self._replicas = [_Replica(i, e) for i, e in enumerate(engines)]
        self._clock = clock
        self.max_queue_requests = max_queue_requests
        self.max_queue_tokens = max_queue_tokens
        # retry budget: a request may survive at most this many replica
        # deaths via failover re-queue; past it, it is quarantined as
        # FAILED_POISON instead of being handed to (and possibly killing)
        # yet another replica
        if max_request_retries < 0:
            raise ValueError("max_request_retries must be >= 0")
        self.max_request_retries = int(max_request_retries)
        self.brownout = brownout
        self._brownout_level = 0
        self._brownout_pressure_steps = 0
        self._brownout_clear_steps = 0
        # fleet-wide per-class caps on committed (queued + running) tokens:
        # the frontend owns admission, so the budget holds across however
        # many local or remote replicas currently exist
        self.class_token_budgets = (
            {Priority(k): int(v) for k, v in class_token_budgets.items()}
            if class_token_budgets else None)
        self._class_tokens: Dict[Priority, int] = {p: 0 for p in Priority}
        self.preemption = bool(preemption)
        self.metrics = metrics if metrics is not None else ServingMetrics(clock)
        # per-request tracing: None = every hook is one test
        self.tracer = tracer
        # disaggregated prefill/decode: fleet-wide KV directory
        # + transfer fabric.  None = classic colocated serving, zero new
        # code on any hot path.  See the "Disaggregation" docstring section.
        self.fabric = kv_fabric
        # multi-tenant platform: None = single-tenant serving,
        # zero new code on any hot path.  See the "Tenancy" docstring.
        self.tenants = tenants
        # replica idx -> model_id: drain-for-swap in progress (a replica
        # being emptied so swap-on-demand routing can re-weight it)
        self._pending_swaps: Dict[int, str] = {}
        self._queue: List[_FrontendRequest] = []
        self._requests: Dict[int, _FrontendRequest] = {}
        self._results: Dict[int, RequestResult] = {}
        self._next_rid = 0
        # synchronous typed rejections draw from a separate NEGATIVE rid
        # space: they are never journaled, so giving them durable-space
        # rids would let a recovered frontend re-issue a rid some client
        # still holds
        self._next_reject_rid = -1
        self._next_seq = 0
        # HA leadership: fencing epoch + renewable lease.
        # The epoch rides every control RPC; a StaleEpoch back from any
        # replica (or a failed renew) deposes this frontend terminally.
        if lease is not None:
            if lease.epoch is None:
                raise ValueError(
                    "lease not acquired — call lease.acquire() (or go "
                    "through StandbyFrontend) before constructing the "
                    "frontend with it")
            if epoch is None:
                epoch = lease.epoch
            elif epoch != lease.epoch:
                raise ValueError(
                    f"explicit epoch {epoch} != held lease epoch "
                    f"{lease.epoch} — the lease is the epoch authority")
        self.lease = lease
        self.epoch = int(epoch) if epoch is not None else None
        self._next_renew_t = -float("inf")
        self._deposed = False
        self._deposed_reason: Optional[str] = None
        self._handed_off = False
        if self.epoch is not None:
            self.metrics.set_gauge("lease_epoch", float(self.epoch))
        if self.fabric is not None and self.epoch is not None:
            # fence the fabric at this frontend's epoch: directory entries
            # stamped by a deposed incarnation become StaleEpoch on lookup
            self.fabric.set_epoch(self.epoch)
        for rep in self._replicas:
            self._propagate_epoch(rep)
        self._rr = 0  # round-robin cursor for routing tie-breaks
        self._next_replica_idx = len(self._replicas)
        # durable control plane: write-ahead request journal +
        # idempotent submission.  The journal (when armed) records the
        # lifecycle, never the tokens — see the Durability docstring.
        if isinstance(journal, (str, os.PathLike)):
            journal = RequestJournal(journal)
        if journal is not None:
            # (recover() constructs the frontend journal-less and
            # attaches the replayed journal afterwards, so this guard
            # only ever sees the fresh-start path)
            # arm-time guard: a fresh frontend restarts rids at 0, so
            # appending into a previous life's journal would merge two
            # rid generations — a later recover() would then stub live
            # requests with the old life's terminals (silent loss).  A
            # journal with history belongs to recover(); a corrupt file
            # raises loudly here, at operator setup time
            prev_snap, prev_recs = journal.replay()
            if prev_snap is not None or prev_recs:
                raise ValueError(
                    f"journal {journal.path!r} already holds "
                    f"{len(prev_recs)} record(s)"
                    + (" + a snapshot" if prev_snap is not None else "")
                    + " from a previous frontend life — recover it with "
                    "ServingFrontend.recover(journal, engines) instead of "
                    "arming a fresh frontend with it (rid generations "
                    "would silently merge)")
        self.journal = journal
        self.journal_compact_every = int(journal_compact_every)
        self._journal_degraded = False
        self._journal_error: Optional[str] = None
        self._records_since_compact = 0
        # one step's PROGRESS + in-step TERMINAL records, group-committed
        # with a single fsync at the end of step() (per-record fsync on
        # the decode hot path would cost a disk barrier per active or
        # completing request per megastep).  Safe for terminals because
        # a result only becomes observable after step() returns, by
        # which point the batch is flushed; a crash inside the window
        # just re-executes the request token-identically on recovery.
        self._step_records: List[Dict] = []
        self._in_step = False
        if idempotency_cache_size < 1:
            raise ValueError("idempotency_cache_size must be >= 1")
        self.idempotency_cache_size = int(idempotency_cache_size)
        self._idem_open: Dict[str, int] = {}     # key -> rid, in flight
        # key -> rid for terminal requests; bounded ring (the "bounded
        # terminal-result cache" client retries dedupe against)
        self._idem_done: "OrderedDict[str, int]" = OrderedDict()
        if journal is not None:
            self.metrics.set_gauge("journal_degraded", 0.0)
            if self.epoch is not None:
                # journal header: the writer epoch is the first durable
                # record a fresh epoch-armed frontend lays down, so a
                # later recover() can refuse stale incarnations and arm
                # at epoch+1 (recover() reattaches its journal after the
                # snapshot rewrite and the snapshot carries the epoch)
                self._journal_append({"t": EPOCH, "epoch": self.epoch,
                                      "nr": self._next_rid})

    @classmethod
    def from_model(cls, model, num_replicas: int = 1, frontend_kwargs=None,
                   **engine_kwargs) -> "ServingFrontend":
        # the port's engines default to CUDA: build them where the model is
        engine_kwargs.setdefault("device", next(model.parameters()).device)
        engines = [ServingEngine(model, **engine_kwargs)
                   for _ in range(num_replicas)]
        return cls(engines, **(frontend_kwargs or {}))

    # ----------------------------------------------------------- public API
    @property
    def replicas(self) -> List[_Replica]:
        return list(self._replicas)

    @property
    def num_live_replicas(self) -> int:
        return sum(r.alive for r in self._replicas)

    def add_replica(self, engine) -> _Replica:
        """Attach a new replica (in-process engine or RemoteReplica proxy)
        at runtime — the fleet autoscaler's scale-up hook.  The next
        ``step()`` starts routing to it."""
        rep = _Replica(self._next_replica_idx, engine)
        self._next_replica_idx += 1
        self._replicas.append(rep)
        self._propagate_epoch(rep)
        return rep

    # --------------------------------------------------- leadership (HA)
    @property
    def deposed(self) -> bool:
        """True once this frontend lost leadership (a replica fenced it
        with ``StaleEpoch``, or a lease renew found a newer epoch): it
        must stop stepping — the successor owns the requests and the
        journal."""
        return self._deposed

    @property
    def handed_off(self) -> bool:
        return self._handed_off

    def _propagate_epoch(self, rep: _Replica):
        """Stamp the frontend's epoch on a replica that supports fencing
        (``RemoteReplica`` / ``FencedEngine`` ``set_epoch``); plain
        engines ignore epochs — fencing is opt-in per replica type."""
        if self.epoch is None:
            return
        fn = getattr(rep.engine, "set_epoch", None)
        if fn is not None:
            fn(self.epoch)

    def _depose(self, reason: str):
        """Terminal loss of leadership.  No replica is killed and NOTHING
        is re-queued or finished: the new incarnation already recovered
        every admitted request from the journal, so acting on them here
        would double-execute.  Journaling stops too — the file belongs
        to the successor now."""
        if self._deposed:
            return
        self._deposed = True
        self._deposed_reason = reason
        if self.tracer is not None:
            self.tracer.process_event("depose", epoch=self.epoch)
        self._step_records = []
        if self.journal is not None:
            try:
                self.journal.close()
            # graft-lint: disable=typed-termination — deposed path: we are
            # the stale writer, the successor owns the file; any close
            # fault here is moot
            except Exception:  # noqa: BLE001 — already the stale writer
                pass

    def _fenced(self, exc: StaleEpoch,
                replica: Optional[_Replica] = None) -> None:
        """A replica rejected this frontend's epoch: count it, depose,
        and re-raise — the typed 'stop stepping' signal, never a
        failover.  Exactly-once counter discipline (same as the prefix/
        orphan-reap folds): a RemoteReplica's WORKER already counted the
        fence into its own scraped registry, so only count fences from
        replicas that do not self-report (in-process FencedEngines) —
        an aggregation folding both registries must see one event per
        fenced RPC, not two."""
        eng = replica.engine if replica is not None else None
        if not getattr(eng, "fences_self_reported", False):
            self.metrics.inc("fenced_rpcs_total")
        if self.tracer is not None:
            self.tracer.process_event("fenced", epoch=self.epoch)
        self._depose(f"fenced by a replica: {exc}")
        raise exc

    def _depose_and_raise(self, reason: str,
                          cause: Optional[BaseException] = None):
        """Depose and raise the typed 'stop stepping' signal — shared by
        every non-replica deposition source (lost lease renew,
        superseded journal)."""
        self._depose(reason)
        raise StaleEpoch(
            f"frontend epoch {self.epoch} deposed: {self._deposed_reason}"
            " — stop stepping and defer to the current incarnation"
        ) from cause

    def _maintain_lease(self):
        """Renew the leadership lease on a ttl/3 cadence; losing it
        deposes this frontend BEFORE any worker RPC is wasted (a resumed
        zombie usually dies here, not at a worker fence).  Transport
        faults are absorbed by the lease's own jittered retries; a
        definitive 'someone newer holds it' answer is terminal."""
        now = self._clock()
        if now < self._next_renew_t:
            return
        self._next_renew_t = now + self.lease.ttl_s / 3.0
        try:
            ok = self.lease.renew()
        except Exception:  # noqa: BLE001 — injected lease fault
            # a faulted renew path (lease.renew failpoint, KV wedge) is
            # indistinguishable from a slow KV: keep serving — fencing
            # is the safety net — and retry at the NEXT cadence point
            # (already armed above).  Retrying every step would block
            # the decode hot path in renew()'s backoff sleeps for the
            # whole outage, collapsing throughput for every request.
            return
        if not ok:
            self._depose_and_raise("lease lost: a newer epoch holds "
                                   f"{self.lease.key!r}")
        if self.tracer is not None:
            self.tracer.process_event("lease_renew", epoch=self.epoch)

    def remove_replica(self, replica: _Replica):
        """Detach a replica.  It must be idle (drained) or dead — removing
        one with in-flight requests would orphan them silently, which the
        failover path exists to prevent."""
        if replica.alive and replica.requests:
            raise RuntimeError(
                f"remove_replica: replica {replica.idx} still has "
                f"{len(replica.requests)} in-flight request(s) — drain it "
                "first (draining=True, wait for them to finish) or let "
                "failover reap it")
        self._replicas.remove(replica)

    def fail_replica(self, replica: _Replica, exc: BaseException):
        """Mark a replica dead and re-queue its in-flight requests from
        host-side state (public face of the failover path, used by the
        fleet heartbeat when a SILENT worker — one that never gets stepped
        because it looks idle, or whose health probe times out — must
        trigger the same recovery as a step() fault)."""
        if replica.alive:
            self._kill_replica(replica, exc)

    def rolling_swap(self, new_weights, version: str, *,
                     model_id: Optional[str] = None,
                     step: Optional[Callable[[], None]] = None,
                     max_steps: int = 10_000) -> int:
        """Zero-downtime rolling weight swap: one replica at
        a time, drain → load version-labelled weights → re-admit.  See
        the "Rolling weight swaps" docstring section for the exact
        guarantee (zero dropped admitted requests; greedy+seeded token
        parity for requests completing on one version; a swap fault
        keeps the replica on its OLD version).

        ``new_weights`` is whatever each replica's ``load_weights``
        accepts — a model for in-process engines, a worker spec dict for
        ``fleet.RemoteReplica``.  ``step`` drives the control loop while
        replicas drain (defaults to ``self.step``;
        ``ServingFleet.rolling_swap`` passes the fleet step so
        heartbeats and autoscaling keep running).  Returns the number of
        replicas now serving ``version``."""
        step_fn = step if step is not None else self.step
        swapped = 0
        for rep in list(self._replicas):
            if not rep.alive:
                continue
            fn = getattr(rep.engine, "load_weights", None)
            if fn is None:
                self.metrics.inc("weight_swap_failures_total")
                continue
            rep.draining = True
            rep.swapping = True    # scale-down must not reap a swapper
            try:
                waited = 0
                while rep.alive and (rep.requests or rep.engine._queue
                                     or rep.engine.num_active):
                    step_fn()
                    waited += 1
                    if waited > max_steps:
                        raise TimeoutError(
                            f"rolling_swap: replica {rep.idx} did not "
                            f"drain within {max_steps} steps — inspect "
                            "its in-flight requests before retrying")
                if not rep.alive:
                    continue      # died mid-drain; failover already ran
                try:
                    fn(new_weights, version=version, model_id=model_id)
                except StaleEpoch as e:
                    self._fenced(e, rep)
                except Exception:  # noqa: BLE001 — swap fault: the
                    # replica keeps serving its OLD weights version
                    self.metrics.inc("weight_swap_failures_total")
                    if self.tracer is not None:
                        self.tracer.process_event("weights_swap_failed",
                                                  replica=rep.idx,
                                                  version=version)
                    continue
                if self.fabric is not None:
                    # old-version directory entries must never serve a
                    # new-version pull
                    self.fabric.drop_owner(self._replica_name(rep))
                swapped += 1
                self.metrics.inc("weight_swaps_total")
                if self.tracer is not None:
                    self.tracer.process_event("weights_swap",
                                              replica=rep.idx,
                                              version=version)
            finally:
                rep.draining = False
                rep.swapping = False
        return swapped

    @property
    def pending(self) -> int:
        """Requests submitted but not yet resolved to a RequestResult."""
        return len(self._requests) - len(self._results)

    def result(self, rid: int) -> Optional[RequestResult]:
        return self._results.get(rid)

    def results(self) -> Dict[int, RequestResult]:
        return dict(self._results)

    def submit(self, prompt_ids, max_new_tokens: int = 32, *,
               priority: Priority = Priority.NORMAL,
               deadline_s: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0, logprobs: bool = False,
               spec: bool = True,
               idempotency_key: Optional[str] = None,
               tenant: Optional[str] = None,
               on_token: Optional[Callable[[int, int], None]] = None) -> int:
        """Enqueue a request; never blocks. Returns a rid whose outcome is
        readable via ``result(rid)`` — immediately for typed rejections
        (OVERLOADED / FAILED), after ``step()``/``run()`` otherwise.
        ``deadline_s`` is relative to submission.

        Sampling: ``temperature=0`` (default) is exact greedy;
        ``temperature>0`` samples in-graph through the top-k/top-p
        filters under a per-request seed whose stream survives
        preemption/failover resumes.  ``logprobs=True`` attaches raw-logit
        logprobs to the result.  ``on_token(rid, tok)`` is invoked for
        every harvested token in order (in bursts of up to the engine's
        ``megastep_k`` per step); a callback that raises is disabled for
        that request and counted in ``stream_callback_errors_total``.

        ``idempotency_key`` dedupes client retries: a resubmission whose
        key matches an in-flight or terminal request returns the ORIGINAL
        rid (counted in ``idempotent_hits_total``) instead of executing
        twice — across frontend restarts too, when a journal is armed
        (keys ride the admit/terminal records).  Only ADMITTED requests
        claim their key: a typed rejection (OVERLOADED etc.) never
        executed, so retrying it for real is safe and correct.

        Rid spaces: admitted requests get non-negative rids (durable,
        journaled with a high-water mark); synchronous typed rejections
        get NEGATIVE rids — valid handles for ``result``/``cancel`` in
        this process, never journaled and never re-issued by a
        recovered frontend (do not hold them across a restart)."""
        if self._deposed:
            raise StaleEpoch(
                f"frontend deposed ({self._deposed_reason}) — submit to "
                "the current incarnation")
        if self._handed_off:
            raise HandedOff(
                "frontend handed off — submit to the successor")
        if idempotency_key is not None:
            prev = self._idem_open.get(idempotency_key,
                                       self._idem_done.get(idempotency_key))
            if prev is not None:
                # a reconnecting streaming client gets its NEW callback
                # attached to the still-open request (future tokens only;
                # tokens generated before the reconnect are in
                # result(prev)/the request state once terminal)
                live = self._requests.get(prev)
                if (on_token is not None and live is not None
                        and prev not in self._results):
                    live.on_token = on_token
                self.metrics.inc("idempotent_hits_total")
                return prev
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        sampling = SamplingParams(temperature=float(temperature),
                                  top_k=int(top_k), top_p=float(top_p),
                                  seed=int(seed), logprobs=bool(logprobs),
                                  spec=bool(spec))
        tenant_name = tenant
        if self.tenants is not None:
            # tenancy: unknown tenants fold into "default";
            # the ceiling clamps the class BEFORE any class-budget math
            spec = self.tenants.get(tenant)
            tenant_name = spec.name
            priority = Priority(spec.clamp_priority(int(priority)))
        now = self._clock()
        # the durable rid is only CLAIMED on admission below; a rejected
        # request is re-homed into the negative space by _reject
        req = _FrontendRequest(
            rid=self._next_rid, prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            priority=Priority(priority),
            deadline_t=(now + deadline_s) if deadline_s is not None else None,
            eos_token_id=eos_token_id, submit_t=now, seq=self._next_seq,
            sampling=sampling, on_token=on_token,
            idempotency_key=idempotency_key)
        req.tenant = tenant_name
        self._next_seq += 1

        live = [r for r in self._replicas if r.alive]
        if not live:
            return self._reject(req, RequestStatus.FAILED,
                                "no live replicas")
        accepting = [r for r in live if not r.draining]
        if not accepting:
            return self._reject(
                req, RequestStatus.OVERLOADED,
                "every live replica is draining (fleet scale-down "
                "in progress) — not admitting")
        # brownout degradation (level maintained by step() with
        # hysteresis): shed the cheapest class first, then shrink NORMAL
        # work; HIGH is never degraded
        if self._brownout_level >= 1 and req.priority is Priority.LOW:
            return self._reject(
                req, RequestStatus.REJECTED_BROWNOUT,
                f"brownout level {self._brownout_level}: LOW "
                "admission shed under sustained queue/pool "
                "pressure — retry later or raise priority")
        if self._brownout_level >= 2 and req.priority is Priority.NORMAL:
            cap = self.brownout.normal_max_new_tokens
            if req.max_new_tokens > cap:
                req.capped_from = req.max_new_tokens
                req.max_new_tokens = cap
                self.metrics.inc("brownout_capped_total")
        if not any(self._fits_at_all(r, req) for r in accepting):
            return self._reject(
                req, RequestStatus.OVERLOADED,
                f"prompt+max_new_tokens={req.total_tokens} exceeds "
                "every live replica's capacity")
        if (self.max_queue_requests is not None
                and len(self._queue) >= self.max_queue_requests):
            return self._reject(
                req, RequestStatus.OVERLOADED,
                f"queue full ({self.max_queue_requests} requests)")
        if self.max_queue_tokens is not None:
            committed = sum(q.total_tokens for q in self._queue)
            if committed + req.total_tokens > self.max_queue_tokens:
                return self._reject(
                    req, RequestStatus.OVERLOADED,
                    f"queued token budget exhausted ({committed}"
                    f"+{req.total_tokens} > {self.max_queue_tokens})")
        if self.class_token_budgets is not None:
            cap = self.class_token_budgets.get(req.priority)
            held = self._class_tokens[req.priority]
            if cap is not None and held + req.total_tokens > cap:
                return self._reject(
                    req, RequestStatus.OVERLOADED,
                    f"class {req.priority.name} token budget "
                    f"exhausted ({held}+{req.total_tokens} > {cap} "
                    "fleet-wide)")
        if (self.tenants is not None
                and not self.tenants.budget_allows(req.tenant,
                                                   req.total_tokens)):
            spec = self.tenants.get(req.tenant)
            self.metrics.inc("tenant_rejected_budget_total")
            return self._reject(
                req, RequestStatus.OVERLOADED,
                f"tenant {spec.name!r} token budget exhausted "
                f"({self.tenants.outstanding(spec.name)}"
                f"+{req.total_tokens} > {spec.token_budget} outstanding "
                "fleet-wide) — the per-tenant admission contract, not "
                "fleet capacity")
        rid = req.rid
        self._next_rid += 1
        self._requests[rid] = req
        req.counted_tokens = req.total_tokens
        self._class_tokens[req.priority] += req.counted_tokens
        if self.tenants is not None:
            self.tenants.charge(req.tenant, req.counted_tokens)
        self._queue.append(req)
        req.admitted = True
        if idempotency_key is not None:
            self._idem_open[idempotency_key] = rid
        if self.tracer is not None:
            # minted BEFORE the admit record so the trace id rides it
            # (a journal-recovered request keeps its trace)
            req.trace = self.tracer.begin(rid)
            admit_extra = ({"tenant": req.tenant}
                           if req.tenant is not None else {})
            self.tracer.event(req.trace, "admit",
                              priority=int(req.priority),
                              prompt_len=len(prompt),
                              max_new_tokens=req.max_new_tokens,
                              **admit_extra)
            self.tracer.event(req.trace, "queue", depth=len(self._queue))
        # write-ahead: the admit record is durable BEFORE the request can
        # reach a replica, so a crash after this line cannot lose it
        self._journal_append(self._admit_record(req))
        self.metrics.inc("admitted_total")
        return rid

    def _reject(self, req: _FrontendRequest, status: RequestStatus,
                detail: str) -> int:
        """Resolve a synchronous typed rejection.  The request moves to
        the NEGATIVE rid space: it never executed and is never
        journaled, so the durable (non-negative) rid space stays exactly
        'rids the journal's high-water mark covers' — recovery can never
        re-issue a rid any client saw."""
        req.rid = self._next_reject_rid
        self._next_reject_rid -= 1
        self._requests[req.rid] = req
        self._finish(req, status, detail)
        return req.rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or running request; returns False if already
        resolved (or unknown)."""
        if self._deposed:
            raise StaleEpoch(
                f"frontend deposed ({self._deposed_reason}) — the "
                "current incarnation owns this request; cancel there")
        if self._handed_off:
            # same inertness contract as submit/step: the successor owns
            # every open request — an evict from here would kill ITS
            # in-flight sequence (epoch=None deployments have no fence
            # to stop it), and a terminal append would reopen the WAL
            # behind the final handoff snapshot
            raise HandedOff(
                "frontend handed off — cancel on the successor")
        req = self._requests.get(rid)
        if req is None or rid in self._results:
            return False
        if req in self._queue:
            self._queue.remove(req)
        elif req.replica is not None:
            rep = req.replica
            try:
                rep.engine.evict(req.engine_rid)
            except KeyError:
                pass  # engine already retired it; harvest races are benign
            except StaleEpoch as e:
                self._fenced(e, rep)     # deposed: raises, never failover
            except Exception as e:  # noqa: BLE001 — remote replica fault
                # a dead/hung remote replica fails over like a step() fault;
                # _kill_replica re-queues its requests (incl. this one) —
                # pull it back out before finishing it as cancelled
                self._kill_replica(rep, e)
                if req in self._queue:
                    self._queue.remove(req)
            rep.requests.pop(req.engine_rid, None)
            req.replica = None
            req.engine_rid = None
        self._finish(req, RequestStatus.CANCELLED, "cancelled by caller")
        return True

    def step(self):
        """One control-plane iteration: renew leadership (when leased),
        shed expired deadlines, dispatch (with preemption), step every
        live replica, harvest tokens and completions, sample metrics.
        Raises the typed ``StaleEpoch`` once this frontend is deposed —
        the caller must stop and defer to the current incarnation."""
        if self._deposed:
            raise StaleEpoch(
                f"frontend deposed ({self._deposed_reason}) — stop "
                "stepping and defer to the current incarnation")
        if self._handed_off:
            raise HandedOff("frontend handed off — drive the successor")
        if self.lease is not None:
            self._maintain_lease()
        live = [r for r in self._replicas if r.alive]
        if not live:
            for req in list(self._queue):
                self._queue.remove(req)
                self._finish(req, RequestStatus.FAILED, "no live replicas")
            self._sample_gauges()
            return
        self._shed_expired()
        self._update_brownout()
        self._dispatch()
        stepping = [rep for rep in self._replicas
                    if rep.alive and (rep.engine.num_active
                                      or rep.engine._queue)]
        # remote replicas overlap their engine steps: begin_step issues the
        # RPC asynchronously, step() below collects it — fleet step latency
        # is the max of the workers' round trips, not the sum.  In-process
        # engines have no begin_step and run synchronously as before.
        for rep in stepping:
            begin = getattr(rep.engine, "begin_step", None)
            if begin is not None:
                try:
                    begin()
                # graft-lint: disable=typed-termination — begin_step is a
                # concurrency prefetch; a faulting replica raises the same
                # fault from step() below, where failover handles it typed
                except Exception:  # noqa: BLE001 — surfaced by step() below
                    pass
        self._in_step = True
        try:
            for rep in stepping:
                self._step_replica(rep)
        finally:
            self._in_step = False
            self._flush_step_records()
        if self.tracer is not None:
            # graft engine/worker-side span events (prefill done, megastep
            # boundaries) onto the fleet-wide trees; a RemoteReplica's pop
            # is a local buffer drain, so no RPC fault can fire here
            for rep in self._replicas:
                fn = getattr(rep.engine, "pop_trace_events", None)
                if fn is not None:
                    self.tracer.absorb(fn())
        self._sample_gauges()
        if (self._journaling
                and self._records_since_compact >= self.journal_compact_every):
            self._compact_journal()

    def run(self, max_steps: int = 10_000) -> Dict[int, RequestResult]:
        """Drive ``step()`` until every submitted request has a result.
        Raises RuntimeError if ``max_steps`` is exhausted with requests
        still unresolved (a truncated run must not look complete)."""
        for _ in range(max_steps):
            if not self.pending:
                break
            self.step()
        if self.pending:
            stuck = [r.rid for r in self._requests.values()
                     if r.rid not in self._results]
            raise RuntimeError(
                f"ServingFrontend.run: max_steps={max_steps} exhausted with "
                f"{len(stuck)} unresolved request(s) {stuck[:8]} — raise "
                "max_steps or inspect metrics.snapshot()")
        return dict(self._results)

    def stream(self, rid: int, max_steps: int = 10_000):
        """Iterator over one request's tokens, in order, as they are
        generated: drives ``step()`` (the whole frontend progresses, so
        concurrent requests keep being served) and yields ``rid``'s new
        tokens after each boundary — arriving in bursts of up to the
        engine's ``megastep_k``, each burst yielded token-by-token.
        Returns when the request reaches a terminal result (check
        ``result(rid)`` for the status — a shed/cancelled stream simply
        ends after its partial tokens).  Raises KeyError for an unknown
        rid and RuntimeError when ``max_steps`` pass without a result."""
        if rid not in self._requests:
            raise KeyError(f"unknown rid {rid}")
        sent = 0
        for _ in range(max_steps):
            res = self._results.get(rid)
            toks = (res.tokens if res is not None
                    else self._requests[rid].generated)
            while sent < len(toks):
                yield toks[sent]
                sent += 1
            if res is not None:
                return
            self.step()
        raise RuntimeError(
            f"ServingFrontend.stream: max_steps={max_steps} exhausted with "
            f"request {rid} still unresolved")

    # ---------------------------------------------------------- durability
    @property
    def journal_degraded(self) -> bool:
        """True when a journal I/O fault forced non-durable serving (the
        ``journal_degraded`` gauge's backing flag; ``_journal_error``
        carries the fault)."""
        return self._journal_degraded

    @property
    def _journaling(self) -> bool:
        """The ONE armed-and-healthy check every journal site gates on
        (a deposed OR handed-off frontend stops writing too — the
        journal belongs to the successor, and stale appends would
        corrupt ITS state)."""
        return (self.journal is not None and not self._journal_degraded
                and not self._deposed and not self._handed_off)

    def _journal_append(self, rec: Dict) -> None:
        """Append one lifecycle record; a failing journal DEGRADES the
        frontend to non-durable serving (loud gauge + counter) — it never
        kills the data plane."""
        self._journal_append_batch([rec])

    def _journal_append_batch(self, recs: List[Dict]) -> None:
        if not self._journaling or not recs:
            return
        try:
            n = self.journal.append_batch(recs)
        except JournalSuperseded as e:
            # the journal FILE was replaced by a successor's recovery
            # compaction: that is a deposition signal (RPC fencing can't
            # see file writes), never a degradable I/O fault — degrading
            # would keep this stale incarnation serving un-journaled
            self._depose_and_raise(f"journal superseded: {e}", cause=e)
        except Exception as e:  # noqa: BLE001 — any I/O fault degrades
            self._journal_degrade(e)
            return
        self._records_since_compact += len(recs)
        self.metrics.inc("journal_records_total", len(recs))
        self.metrics.inc("journal_bytes_total", n)

    def _flush_step_records(self):
        """Group-commit the step's buffered PROGRESS and in-step
        TERMINAL records: one fsync per control step, not one per
        active/completing request."""
        if self._step_records:
            pending, self._step_records = self._step_records, []
            self._journal_append_batch(pending)

    def _progress_record(self, req: _FrontendRequest) -> Dict:
        """Durable mid-flight state: token count (observability), the
        live retry budget, and the REMAINING deadline — recovery re-arms
        the SLO clock from the latest of these, not from the admit
        record's submit-time (near-full) budget."""
        rec = {"t": PROGRESS, "rid": req.rid, "n": len(req.generated),
               "attempts": req.attempts}
        if req.deadline_t is not None:
            rec["dl"] = req.deadline_t - self._clock()
        return rec

    def _journal_degrade(self, exc: BaseException):
        self._journal_degraded = True
        self._journal_error = repr(exc)
        self.metrics.inc("journal_errors_total")
        self.metrics.set_gauge("journal_degraded", 1.0)

    def _admit_record(self, req: _FrontendRequest) -> Dict:
        """The durable form of one admitted request — everything needed
        to re-admit it after a crash (prompt, sampling wire dict, class,
        REMAINING deadline seconds, budget fields, idempotency key).
        Shared by submit-time journaling and compaction snapshots."""
        rem = (req.deadline_t - self._clock()
               if req.deadline_t is not None else None)
        # "nr" pins the rid high-water mark so recovery continues the
        # durable rid space exactly where this life left it (typed
        # rejections live in their own negative space and never touch
        # it); "attempts" preserves the retry
        # budget across restarts — a poison request must not get a fresh
        # budget per frontend life (snapshots re-serialize open requests
        # through here, so a compacted journal carries the current count)
        return {"t": ADMIT, "rid": req.rid, "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "priority": int(req.priority),
                "deadline_s": rem, "eos": req.eos_token_id,
                "sampling": req.sampling.to_wire(),
                "key": req.idempotency_key,
                "attempts": req.attempts, "nr": self._next_rid,
                "tenant": req.tenant,
                "trace": (req.trace.trace_id
                          if req.trace is not None else None)}

    def _snapshot_state(self) -> Dict:
        """Compaction snapshot: open admits + the bounded keyed-terminal
        cache + the rid high-water mark.  Closed unkeyed requests need
        nothing — their admit+terminal pair cancels out."""
        open_recs = [self._admit_record(r)
                     for r in sorted(self._requests.values(),
                                     key=lambda r: r.rid)
                     if r.admitted and r.rid not in self._results]
        done = []
        for key, rid in self._idem_done.items():
            res = self._results.get(rid)
            if res is None:
                continue
            done.append({"rid": rid, "key": key, "status": res.status.value,
                         "n_tokens": len(res.tokens),
                         "attempts": res.attempts})
        return {"t": "snapshot", "next_rid": self._next_rid,
                "open": open_recs, "done": done, "epoch": self.epoch}

    def _compact_journal(self):
        try:
            self.journal.rewrite(self._snapshot_state())
        except JournalSuperseded as e:
            # a successor already os.replace'd the path (recovery always
            # compacts): proceeding would install THIS incarnation's
            # stale snapshot over the successor's live WAL — the exact
            # split-brain corruption the epoch fence exists to prevent.
            # Depose instead; the old journal content is untouched.
            self._depose_and_raise(f"journal superseded: {e}", cause=e)
        except Exception as e:  # noqa: BLE001 — degrade, never crash
            self._journal_degrade(e)
            return
        self._records_since_compact = 0
        self.metrics.inc("journal_compactions_total")

    def handoff(self):
        """Zero-downtime leadership handoff (rolling frontend upgrades):
        stop admitting, group-commit the buffered in-step
        terminals, write a final compaction snapshot (open admits + the
        idempotency map + the writer epoch, through the
        ``handoff.flush`` failpoint), release the lease EARLY, and stop.

        The successor (a ``StandbyFrontend`` polling the lease, or an
        operator running ``recover``) takes over at epoch+1 with ZERO
        dropped admitted requests — open requests ride the snapshot and
        re-admit; in-flight sequences on the engines are reaped and
        replay token-identically — and the idempotency map intact, so
        clients that replay their keys get their original rids.  Unlike
        a crash, nothing ever fences: this frontend stops itself before
        the successor's epoch exists, so no ``StaleEpoch`` fires
        anywhere (the chaos soak asserts exactly that).

        After handoff this frontend is inert: ``step``/``submit`` raise
        RuntimeError pointing at the successor.  A journal-flush fault
        degrades (the un-compacted journal still recovers fully) — it
        never blocks the handoff."""
        if self._handed_off:
            return
        if self._deposed:
            raise StaleEpoch(
                f"cannot hand off a deposed frontend "
                f"({self._deposed_reason}) — the successor already took "
                "over the hard way")
        # terminal records buffered inside an interrupted step (callers
        # normally invoke handoff between steps; this makes mid-step
        # invocation safe too) become durable before the snapshot
        self._flush_step_records()
        if self._journaling:
            inj = self.journal._faults
            try:
                if inj is not None:
                    inj.fire(HANDOFF_FLUSH, detail=str(self.epoch))
                self._compact_journal()
            except StaleEpoch:
                # journal superseded mid-handoff: a successor already
                # took over the hard way — this is a deposition, not a
                # completed handoff
                raise
            except Exception as e:  # noqa: BLE001 — degrade, keep going
                self._journal_degrade(e)
        if self.journal is not None:
            try:
                self.journal.close()   # the successor owns the file now
            except Exception as e:  # noqa: BLE001 — same contract as the
                # compaction above: a flush fault (ENOSPC draining the
                # fsync=False buffer) degrades — aborting HERE would
                # leave the lease held for a full TTL with _handed_off
                # unset, turning a clean handoff into a failover
                self._journal_degrade(e)
        if self.lease is not None:
            try:
                self.lease.release()
            # graft-lint: disable=typed-termination — best-effort early
            # release: a failed release only delays the successor by one
            # TTL, it cannot lose requests
            except Exception:  # noqa: BLE001 — TTL expiry still hands off
                pass
        self._handed_off = True
        if self.tracer is not None:
            self.tracer.process_event("handoff", epoch=self.epoch)
        self.metrics.inc("handoffs_total")

    @classmethod
    def recover(cls, journal, engines, *, reap_orphans: bool = True,
                epoch: Optional[int] = None,
                lease: Optional[FrontendLease] = None,
                **kwargs) -> "ServingFrontend":
        """Rebuild a frontend from a dead one's journal (crash-consistent
        recovery).

        ``journal`` is a :class:`RequestJournal` or a path.  ``engines``
        are the replicas the recovered frontend serves with — fresh
        in-process engines, or ``fleet.RemoteReplica`` proxies for
        workers that OUTLIVED the frontend (discovered via the fleet's
        KV registry).  Steps:

        1. replay the journal (snapshot + suffix; torn tail tolerated,
           mid-file corruption raises ``JournalCorruption`` — recovered
           state over corrupt records would drop or duplicate requests);
        2. reap orphans: every sequence a still-live engine is running
           belongs to the dead frontend and is no longer observed —
           ``reap_orphans()`` evicts them (worker-side over RPC), and
           re-admission below resumes them under supervision (a replica
           whose reap fails is marked dead, normal failover scope);
        3. re-admit every journaled request WITHOUT a terminal record as
           fresh prefill, original rid/priority/sampling preserved,
           deadline re-armed with its journaled remaining budget.
           Greedy determinism + (seed, sample-index) streams make the
           recovered COMPLETED survivors token-identical to a crash-free
           run;
        4. restore the idempotency map (in-flight + bounded terminal
           cache) so client retries straddling the restart dedupe;
        5. compact the journal to a snapshot of the recovered state and
           keep journaling into it.

        Counted in ``recoveries_total`` / ``recovered_requests_total`` /
        ``orphans_reaped_total`` (the latter only for engines that do
        not self-report — a RemoteReplica's worker counts its own reap).

        Rid continuity: journaled rids (admitted requests) are never
        re-issued — every record carries the rid high-water mark ``nr``
        — and typed REJECTIONS draw from a separate negative rid space
        that never intersects it, so NO rid any pre-crash client saw
        can come back attached to a different request.

        Epoch fencing: ``epoch`` (or the acquired ``lease``'s
        epoch) becomes the recovered frontend's fencing epoch and MUST
        exceed the journal's recorded writer epoch — a journal written
        by a higher epoch means the caller is the stale incarnation, and
        recover raises the typed ``StaleEpoch`` instead of silently
        merging two rid generations.  With no explicit epoch, an
        epoch-recorded journal arms the new incarnation at
        ``journal epoch + 1`` automatically.  The orphan reap below is
        the FIRST rpc issued under the new epoch, so taking over also
        fences every older incarnation out of the workers before any
        request is re-admitted."""
        if "journal" in kwargs:
            raise ValueError("recover() owns the journal argument — the "
                             "replayed journal is reattached after the "
                             "snapshot rewrite")
        if isinstance(journal, (str, os.PathLike)):
            journal = RequestJournal(journal)
        snapshot, records = journal.replay()
        admits: Dict[int, Dict] = {}
        terminals: Dict[int, Dict] = {}
        attempts: Dict[int, int] = {}
        deadlines: Dict[int, float] = {}   # latest REMAINING deadline
        next_rid = 0
        journal_epoch: Optional[int] = None
        if snapshot is not None:
            next_rid = int(snapshot.get("next_rid", 0))
            if snapshot.get("epoch") is not None:
                journal_epoch = int(snapshot["epoch"])
            for a in snapshot.get("open", ()):
                admits[int(a["rid"])] = a
            for t in snapshot.get("done", ()):
                terminals[int(t["rid"])] = t
        for rec in records:
            kind = rec.get("t")
            if kind == ADMIT:
                admits[int(rec["rid"])] = rec
            elif kind == TERMINAL:
                terminals[int(rec["rid"])] = rec
            elif kind == PROGRESS:
                # tokens replay from scratch, but the retry budget and
                # the SLO clock do not reset: keep the latest journaled
                # attempts count and remaining deadline
                attempts[int(rec["rid"])] = int(rec.get("attempts", 0))
                if "dl" in rec:
                    deadlines[int(rec["rid"])] = rec["dl"]
            elif kind == EPOCH:
                journal_epoch = max(journal_epoch or 0, int(rec["epoch"]))
            # every record kind may carry the rid high-water mark "nr"
            if "nr" in rec:
                next_rid = max(next_rid, int(rec["nr"]))

        # journal-side fencing: a journal recorded by a HIGHER epoch
        # belongs to a newer incarnation — the caller is the stale one,
        # and "recovering" it would merge two rid generations and stub
        # the successor's live requests with ghost terminals
        if lease is not None and epoch is None:
            epoch = lease.epoch
        if journal_epoch is not None:
            if epoch is None:
                epoch = journal_epoch + 1   # new incarnation arms above
            elif epoch <= journal_epoch:
                # equality is NOT safe: EpochFence admits epoch >= its
                # highest, so recovering at the journal's own epoch
                # would let a zombie of the prior incarnation (same
                # epoch) keep passing every worker fence alongside us
                raise StaleEpoch(
                    f"journal {journal.path!r} was written by epoch "
                    f"{journal_epoch} >= yours ({epoch}): recovery must "
                    "arm STRICTLY above the journal's writer epoch to "
                    "fence the prior incarnation out — pass a higher "
                    "epoch (or none, to auto-arm at journal epoch + 1)")

        fe = cls(engines, epoch=epoch, lease=lease, **kwargs)
        reaped = 0
        if reap_orphans:
            for rep in list(fe._replicas):
                fn = getattr(rep.engine, "reap_orphans", None)
                if fn is None:
                    continue
                try:
                    n = int(fn())
                except StaleEpoch:
                    # OUR epoch got fenced mid-recovery: a yet-newer
                    # incarnation raced past us — abort, we lost
                    raise
                except Exception as e:  # noqa: BLE001 — dead worker
                    fe._kill_replica(rep, e)
                    continue
                # exactly-once counter discipline (same as the prefix/
                # megastep folds): a RemoteReplica's worker already
                # counted its reap into its own registry, which the
                # fleet scrape page exports — only count engines that
                # do NOT self-report
                if not getattr(rep.engine, "prefix_counters_self_reported",
                               False):
                    reaped += n
        if reaped:
            fe.metrics.inc("orphans_reaped_total", reaped)

        all_rids = list(admits) + list(terminals)
        fe._next_rid = max([next_rid] + [r + 1 for r in all_rids], default=0)
        now = fe._clock()
        # terminal stubs: result(rid) keeps answering for requests that
        # closed before the crash (status is authoritative; tokens were
        # delivered pre-crash and are not journaled)
        for rid, t in sorted(terminals.items()):
            stub = _FrontendRequest(
                rid=rid, prompt=[], max_new_tokens=0,
                priority=Priority.NORMAL, deadline_t=None,
                eos_token_id=None, submit_t=now, seq=fe._next_seq,
                idempotency_key=t.get("key"))
            fe._next_seq += 1
            fe._requests[rid] = stub
            if fe.tracer is not None:
                # pre-crash terminals keep their journaled trace id too:
                # the successor's tree carries a "terminal" stub event,
                # so EVERY typed terminal it can answer for owns a
                # complete span tree (the pre-crash spans died with the
                # old incarnation's recorder)
                a = admits.get(rid) or {}
                stub.trace = (fe.tracer.adopt(a["trace"], rid)
                              if a.get("trace") else fe.tracer.begin(rid))
                fe.tracer.event(stub.trace, "terminal",
                                status=t["status"], recovered=True,
                                attempts=int(t.get("attempts", 0)))
            fe._results[rid] = RequestResult(
                rid=rid, status=RequestStatus(t["status"]), tokens=[],
                detail="recovered terminal from journal (tokens are not "
                       "journaled; if this result was never delivered "
                       "before the crash, resubmit WITHOUT the "
                       "idempotency key — greedy/seeded decode "
                       "re-executes token-identically)",
                attempts=int(t.get("attempts", 0)))
            if t.get("key") is not None:
                fe._idem_done[t["key"]] = rid
        while len(fe._idem_done) > fe.idempotency_cache_size:
            fe._idem_done.popitem(last=False)
        # re-admit the open requests as fresh prefill, rid order (oldest
        # first keeps their original relative FIFO position per class)
        recovered = 0
        for rid, a in sorted(admits.items()):
            if rid in terminals:
                continue
            # SLO clock: the latest progress record's remaining deadline
            # beats the admit record's submit-time (near-full) budget —
            # a request that was 1 s from its deadline at the crash must
            # not get its whole window back
            rem = deadlines.get(rid, a.get("deadline_s"))
            req = _FrontendRequest(
                rid=rid, prompt=[int(x) for x in a["prompt"]],
                max_new_tokens=int(a["max_new_tokens"]),
                priority=Priority(int(a["priority"])),
                deadline_t=(now + rem) if rem is not None else None,
                eos_token_id=a.get("eos"), submit_t=now, seq=fe._next_seq,
                sampling=SamplingParams.coerce(a.get("sampling")),
                idempotency_key=a.get("key"))
            fe._next_seq += 1
            # retry budget survives the restart: the admit record (or a
            # compaction snapshot) carries the count at write time, and
            # progress records carry the live value — take the max
            req.attempts = max(int(a.get("attempts", 0)),
                               attempts.get(rid, 0))
            if fe.tracer is not None:
                # the trace id rode the admit record: the recovered
                # request KEEPS its pre-crash trace (same id minted
                # deterministically from the rid either way)
                req.trace = (fe.tracer.adopt(a["trace"], rid)
                             if a.get("trace") else fe.tracer.begin(rid))
                fe.tracer.event(req.trace, "recover",
                                attempts=req.attempts)
            req.admitted = True
            req.tenant = a.get("tenant")
            req.counted_tokens = req.total_tokens
            fe._class_tokens[req.priority] += req.counted_tokens
            if fe.tenants is not None and req.tenant is not None:
                # tenant budgets survive the restart: the re-admitted
                # request holds its outstanding tokens again
                fe.tenants.charge(req.tenant, req.counted_tokens)
            fe._requests[rid] = req
            fe._queue.append(req)
            if req.idempotency_key is not None:
                fe._idem_open[req.idempotency_key] = rid
            recovered += 1
        fe.metrics.inc("recoveries_total")
        fe.metrics.inc("recovered_requests_total", recovered)
        # the recovered state becomes the journal's snapshot; from here
        # the frontend journals into it like any fresh one
        fe.journal = journal
        fe.metrics.set_gauge("journal_degraded", 0.0)
        fe._compact_journal()
        return fe

    # ------------------------------------------------------------ internals
    @property
    def brownout_level(self) -> int:
        """0 = normal, 1 = LOW admission shed, 2 = + NORMAL max_new_tokens
        capped (mirrored in the ``degraded_mode`` gauge)."""
        return self._brownout_level

    def _update_brownout(self):
        """Advance the degradation state machine one control step.

        Escalates one level after ``enter_after`` consecutive pressured
        steps, de-escalates after ``exit_after`` consecutive clear steps;
        readings inside the hysteresis band reset both runs, so the level
        only moves on genuinely sustained signals."""
        pol = self.brownout
        if pol is None:
            return
        accepting = [r for r in self._replicas
                     if r.alive and not r.draining]
        per_rep = len(self._queue) / max(len(accepting), 1)
        total = sum(r.engine.blocks.num_blocks for r in accepting)
        free = sum(r.engine.blocks.num_free for r in accepting)
        util = (1.0 - free / total) if total else 0.0
        pressured = per_rep > pol.queue_high or util > pol.pool_high
        clear = per_rep <= pol.queue_low and util <= pol.pool_low
        if pressured:
            self._brownout_pressure_steps += 1
            self._brownout_clear_steps = 0
        elif clear:
            self._brownout_clear_steps += 1
            self._brownout_pressure_steps = 0
        else:
            self._brownout_pressure_steps = 0
            self._brownout_clear_steps = 0
        if (self._brownout_pressure_steps >= pol.enter_after
                and self._brownout_level < 2):
            self._brownout_level += 1
            self._brownout_pressure_steps = 0
            self.metrics.inc("brownout_transitions_total")
            if self.tracer is not None:
                self.tracer.process_event("brownout",
                                          level=self._brownout_level)
        elif (self._brownout_clear_steps >= pol.exit_after
                and self._brownout_level > 0):
            self._brownout_level -= 1
            self._brownout_clear_steps = 0
            if self.tracer is not None:
                self.tracer.process_event("brownout",
                                          level=self._brownout_level)
        self.metrics.set_gauge("degraded_mode", self._brownout_level)

    def _fits_at_all(self, rep: _Replica, req: _FrontendRequest) -> bool:
        """Could this request run on ``rep`` if the replica were idle?"""
        eng = rep.engine
        if req.total_tokens > eng.max_seq_len:
            return False
        if _blocks_needed(eng, req.total_tokens) > eng.blocks.num_blocks:
            return False
        if (eng.cache_quant == "int8"
                and len(req.prompt) + len(req.generated) > eng.T):
            return False  # int8 prefill must land in one step
        return True

    def _headroom(self, rep: _Replica):
        """(free slots, free blocks) net of requests the engine has queued
        but not yet admitted (same-step adds)."""
        eng = rep.engine
        q_blocks = sum(_blocks_needed(eng, len(q.prompt) + q.max_new_tokens)
                       for q in eng._queue)
        return (len(eng._free_slots) - len(eng._queue),
                eng.blocks.num_free - q_blocks)

    def _shed_expired(self):
        now = self._clock()
        for req in [q for q in self._queue
                    if q.deadline_t is not None and now >= q.deadline_t]:
            self._queue.remove(req)
            self._finish(req, RequestStatus.DEADLINE_EXCEEDED,
                         "deadline expired while queued")
        for rep in self._replicas:
            if not rep.alive:
                continue
            for erid, req in list(rep.requests.items()):
                if req.deadline_t is not None and now >= req.deadline_t:
                    try:
                        rep.engine.evict(erid)
                    except KeyError:
                        pass
                    except StaleEpoch as e:
                        self._fenced(e, rep)
                    except Exception as e:  # noqa: BLE001 — replica fault
                        # failover re-queues the replica's requests; the
                        # expired one is finished below either way
                        self._kill_replica(rep, e)
                    if req in self._queue:   # re-queued by failover
                        self._queue.remove(req)
                    rep.requests.pop(erid, None)
                    req.replica = None
                    req.engine_rid = None
                    self._finish(req, RequestStatus.DEADLINE_EXCEEDED,
                                 "deadline expired mid-generation")
                    if not rep.alive:
                        break

    def _dispatch(self):
        if self.tenants is not None:
            self._maintain_tenant_swaps()
            self._dispatch_tenant_drr()
            return
        # priority order; equal-priority backfill is allowed past a blocked
        # request, strictly-lower is not (it would eat the blocks the
        # blocked class is waiting for, then get preempted right back)
        barrier: Optional[int] = None
        for req in sorted(list(self._queue), key=_FrontendRequest.sort_key):
            if req not in self._queue:
                continue
            if barrier is not None and int(req.priority) > barrier:
                continue
            out = self._place_one(req)
            if out == "stop":
                break
            if out == "blocked":
                barrier = int(req.priority)

    def _dispatch_tenant_drr(self):
        """Deficit round-robin ACROSS tenants, above the priority
        classes: each dispatch round credits every backlogged tenant
        ``quantum * weight`` deficit tokens, then places its requests
        (priority-sorted, with the same intra-class barrier as classic
        dispatch) while their remaining-token cost fits the accumulated
        credit.  A tenant whose queue drains forfeits leftover credit
        (classic DRR — idle tenants cannot bank deficit and burst)."""
        reg = self.tenants
        backlog: Dict[str, List[_FrontendRequest]] = {}
        for q in self._queue:
            backlog.setdefault(reg.resolve(q.tenant), []).append(q)
        if not backlog:
            return
        for name in reg.rotation(list(backlog)):
            reg.add_deficit(name)
            barrier: Optional[int] = None
            for req in sorted(backlog[name], key=_FrontendRequest.sort_key):
                if req not in self._queue:
                    continue
                if barrier is not None and int(req.priority) > barrier:
                    continue
                cost = req.remaining_new_tokens
                if cost > reg.deficit(name):
                    break          # out of credit — next round tops it up
                out = self._place_one(req)
                if out == "stop":
                    return
                if out == "blocked":
                    barrier = int(req.priority)
                elif out == "placed":
                    reg.charge_deficit(name, cost)
            if not any(q in self._queue for q in backlog[name]):
                reg.reset_deficit(name)

    def _place_one(self, req: _FrontendRequest) -> str:
        """Try to place ONE queued request (the shared body of classic
        and DRR dispatch).  Returns ``"placed"`` (assigned), ``"gone"``
        (resolved without placement), ``"skip"`` (stays queued without
        raising the priority barrier — fabric dedup wait or a tenant
        swap in flight), ``"blocked"`` (no capacity for its class), or
        ``"stop"`` (no accepting replicas at all)."""
        live = [r for r in self._replicas if r.alive]
        if not live:
            return "stop"
        # draining replicas take no NEW placements (they finish what
        # they have); queued work waits for accepting capacity
        accepting = [r for r in live if not r.draining]
        if not accepting:
            return "stop"
        if not any(self._fits_at_all(r, req) for r in accepting):
            self._queue.remove(req)
            self._finish(req, RequestStatus.OVERLOADED,
                         f"prompt+max_new_tokens={req.total_tokens} "
                         "exceeds every live replica's capacity")
            return "gone"
        # disaggregation: prefill-role replicas never take
        # decode placements — they exist to run prefill PASSES.  With
        # no fabric (or an all-prefill fleet) the pool is `accepting`
        # unchanged and dispatch behaves exactly as before.
        placing = self._decode_pool(accepting)
        # tenancy: route onto replicas serving the tenant's
        # model (or trigger a swap); the narrowed pool also scopes the
        # fabric plan so cross-model pulls cannot happen
        placing = self._tenant_pool(req, placing)
        if not placing:
            return "skip"      # a swap is draining; blocked on the model,
            # not on capacity — never raises the priority barrier
        if self.fabric is not None and not req.prefill_pass:
            action, frep = self._fabric_plan(req, accepting, placing)
            if action == "wait":
                # a twin prefill is in flight elsewhere — this request
                # stays queued WITHOUT raising the priority barrier
                # (it is blocked on dedup, not on capacity)
                return "skip"
            if action == "prefill":
                self._queue.remove(req)
                self._assign(req, frep)
                return "placed"
            if frep is not None:      # "place" onto the pulled-into rep
                self._queue.remove(req)
                self._assign(req, frep)
                return "placed"
        rep = self._pick_replica(req, placing)
        if rep is None and self.preemption:
            rep = self._preempt_for(req, placing)
        if rep is None:
            return "blocked"
        self._queue.remove(req)
        self._assign(req, rep)
        return "placed"

    # ------------------------------------------------- tenancy
    def _tenant_pool(self, req: _FrontendRequest,
                     pool: List[_Replica]) -> List[_Replica]:
        """Tenant-aware routing, ABOVE prefix affinity: prefer replicas
        already serving the request's tenant's model.  With a
        ``model_provider`` armed, a fleet holding no matching replica
        swaps one on demand — an idle fitting replica immediately, else
        the least-loaded one starts draining for the swap (the request
        stays queued meanwhile).  Without a provider the model id is a
        routing preference, never a wedge."""
        if self.tenants is None:
            return pool
        spec = self.tenants.get(req.tenant)
        mid = spec.model_id
        matching = [r for r in pool
                    if getattr(r.engine, "model_id", "default") == mid]
        if matching:
            if mid != "default":
                self.metrics.inc("tenant_routing_hits_total")
            return matching
        if self.tenants.model_provider is None:
            return pool
        fits = [r for r in pool if self._fits_at_all(r, req)]
        idle = [r for r in fits
                if not r.requests and not r.engine._queue
                and not r.engine.num_active]
        for rep in idle:
            if self._swap_replica(rep, mid):
                self.metrics.inc("tenant_routing_hits_total")
                return [rep]
        self.metrics.inc("tenant_swap_waits_total")
        if fits and not self._pending_swaps:
            # start draining ONE replica for the swap; the request waits
            # queued and _maintain_tenant_swaps completes the swap the
            # moment the replica goes idle
            target = min(fits, key=lambda r: (len(r.requests)
                                              + len(r.engine._queue)))
            target.draining = True
            target.swapping = True
            self._pending_swaps[target.idx] = mid
        return []

    def _maintain_tenant_swaps(self):
        """Complete drain-for-swap transitions: a replica drained on
        behalf of a tenant whose model was not resident is swapped and
        re-admitted the moment it goes idle (dead replicas drop out)."""
        if not self._pending_swaps:
            return
        for rep in self._replicas:
            mid = self._pending_swaps.get(rep.idx)
            if mid is None:
                continue
            if not rep.alive:
                del self._pending_swaps[rep.idx]
                continue
            if rep.requests or rep.engine._queue or rep.engine.num_active:
                continue          # still draining
            del self._pending_swaps[rep.idx]
            self._swap_replica(rep, mid)
            rep.draining = False
            rep.swapping = False

    def _swap_replica(self, rep: _Replica, model_id: str) -> bool:
        """Load ``model_id``'s weights onto an (idle) replica via the
        registry's ``model_provider``.  A fault keeps the old weights
        serving (counted, never a drop); success drops the replica's
        fabric directory entries — old-model KV must not be pulled."""
        provider = self.tenants.model_provider
        fn = getattr(rep.engine, "load_weights", None)
        if provider is None or fn is None:
            return False
        try:
            fn(provider(model_id), model_id=model_id)
        except StaleEpoch as e:
            self._fenced(e, rep)   # deposed: raises, never a failover
        except Exception:  # noqa: BLE001 — swap fault: keep old weights
            self.metrics.inc("weight_swap_failures_total")
            return False
        if self.fabric is not None:
            self.fabric.drop_owner(self._replica_name(rep))
        self.metrics.inc("weight_swaps_total")
        if self.tracer is not None:
            self.tracer.process_event("weights_swap", replica=rep.idx,
                                      model_id=model_id)
        return True

    @staticmethod
    def _decode_pool(reps: List[_Replica]) -> List[_Replica]:
        """Replicas eligible for decode placement: everything not labelled
        'prefill'.  An all-prefill fleet degrades to colocated serving
        (better than wedging the queue on a mislabelled deployment)."""
        pool = [r for r in reps
                if getattr(r.engine, "role", None) != "prefill"]
        return pool or list(reps)

    @staticmethod
    def _replica_name(rep: _Replica) -> str:
        """Directory owner id: the fleet worker name when remote, else a
        frontend-local synthetic one (stable across the frontend's life)."""
        return getattr(rep.engine, "worker", None) or f"replica{rep.idx}"

    def _owner_replica(self, name: str) -> Optional[_Replica]:
        for rep in self._replicas:
            if rep.alive and self._replica_name(rep) == name:
                return rep
        return None

    def _fabric_plan(self, req: _FrontendRequest, accepting: List[_Replica],
                     placing: List[_Replica]):
        """Decide how the fabric serves this request's prefix: pull blocks
        published elsewhere onto a decode replica ("place", rep), run a
        prefill pass on a prefill-role replica ("prefill", rep), queue
        behind an identical in-flight prefill ("wait", None), or fall
        through to normal placement ("place", None).  Every fabric fault
        degrades to recompute — the directory is a hint, never a
        correctness dependency."""
        if req.generated:
            return "place", None      # resumed request: prefix is not the
            # prompt anymore; normal prefix-cache affinity handles it
        bs = int(placing[0].engine.bs)
        hashes = prompt_block_hashes(req.prompt, bs)
        if not hashes:
            return "place", None
        hcache = {bs: hashes}
        local_best = max((self._prefix_affinity(r, req, hcache)
                          for r in placing), default=0)
        if local_best >= len(hashes):
            return "place", None      # fully cached locally already
        try:
            chain = self.fabric.lookup_chain(hashes)
        except Exception:  # noqa: BLE001 — directory unavailable ≠ outage
            self.metrics.inc("fabric_recomputes_total")
            return "place", None
        if len(chain) > local_best:
            # re-plan on pull failure:
            # the chosen decode replica can die between the directory
            # lookup and the transfer — fall back to another live decode
            # replica before giving up on the chain (parity is untouched;
            # pulled blocks are bit-exact wherever they land)
            pool = list(placing)
            while pool:
                target = self._pick_replica(req, pool)
                if target is None:
                    return "place", None
                if self._pull_chain(req, target, chain):
                    return "place", target
                self.metrics.inc("fabric_replans_total")
                pool = [r for r in pool if r is not target and r.alive]
            return "place", None      # pull failed → recompute locally
        # nothing (better) published yet: try to claim a prefill pass
        if req.prefill_passes > 0:
            return "place", None      # one pass per request — a second
            # failure means the fabric is sick; recompute guarantees
            # forward progress
        prefill_pool = [r for r in accepting
                        if getattr(r.engine, "role", None) == "prefill"]
        if not prefill_pool:
            return "place", None
        if not any(self._fits_at_all(r, req) for r in prefill_pool):
            return "place", None
        key = hashes[-1]              # chain head identifies the prompt
        owner = self.fabric.prefill_owner(key)
        if owner is not None:
            self.metrics.inc("fabric_dedup_waits_total")
            return "wait", None
        rep = self._pick_replica(req, prefill_pool)
        if rep is None:
            return "wait", None       # prefill capacity busy; dedup table
            # still guards against a twin racing in meanwhile
        if not self.fabric.begin_prefill(key, self._replica_name(rep),
                                         epoch=self.epoch):
            self.metrics.inc("fabric_dedup_waits_total")
            return "wait", None
        req.prefill_pass = True
        req.prefill_passes += 1
        req.fabric_key = key
        self.metrics.inc("fabric_prefill_passes_total")
        return "prefill", rep

    def _pull_chain(self, req: _FrontendRequest, target: _Replica,
                    chain) -> bool:
        """Stream directory-published blocks (a ``FabricEntry`` chain from
        ``lookup_chain``) onto ``target``, grouped by owning replica; True
        if anything landed.  A dead owner's leases drop out of the
        directory and the caller recomputes."""
        cached_fn = getattr(target.engine, "cached_block_hashes", None)
        cached = cached_fn() if cached_fn is not None else set()
        missing = [e for e in chain if e.hash not in cached]
        if not missing:
            return True
        by_owner: Dict[str, List[str]] = {}
        for entry in missing:
            by_owner.setdefault(entry.owner, []).append(entry.hash)
        pulled = nbytes = 0
        for owner, hs in by_owner.items():
            src = self._owner_replica(owner)
            try:
                if src is None:
                    raise ConnectionError(
                        f"directory owner {owner!r} is not a live replica")
                n, b, transport = self.fabric.pull(
                    src.engine, target.engine, hs, owner=owner,
                    epoch=self.epoch)
                self._note_transport(req, transport, n, b,
                                     self._replica_name(target))
                pulled += n
                nbytes += b
            except StaleEpoch:
                self.metrics.inc("fabric_recomputes_total")
                return pulled > 0
            except Exception:  # noqa: BLE001 — decode-pulls-from-dead-peer
                # drop every entry the dead owner published so the next
                # request doesn't retry the same corpse, then recompute
                self.fabric.drop_owner(owner)
                self.metrics.inc("fabric_pull_failures_total")
                self.metrics.inc("fabric_recomputes_total")
        if pulled and self.tracer is not None and req.trace is not None:
            self.tracer.event(req.trace, "block_transfer", blocks=pulled,
                              bytes=nbytes, dst=self._replica_name(target))
        return pulled > 0

    def _note_transport(self, req: _FrontendRequest, transport: str,
                        blocks: int, nbytes: int, dst: str):
        """Per-transfer transport accounting: count the
        transport rung the fabric ladder landed on, and record a
        ``block_wire`` span event whose bytes/hops fold into the
        replay-equality digest — relayed payloads cross the wire twice
        (prefill→frontend→decode), direct ones once."""
        hops = 1 if transport == "wire" else 2
        self.metrics.inc("fabric_wire_pulls_total" if transport == "wire"
                         else "fabric_relay_pulls_total")
        if self.tracer is not None and req.trace is not None:
            self.tracer.event(req.trace, "block_wire", blocks=int(blocks),
                              bytes=int(nbytes), hops=hops,
                              transport=transport, dst=dst)

    def _prefix_affinity(self, rep: _Replica, req: _FrontendRequest,
                         hash_cache: Dict[int, List[str]]) -> int:
        """Consecutive full blocks of the request's (resumed) prefill that
        are already cached on ``rep`` — the routing score that sends
        shared-prefix traffic where its KV lives.  ``hash_cache`` memoizes
        the prompt's chain hashes per block size across replicas."""
        cached_fn = getattr(rep.engine, "cached_block_hashes", None)
        if cached_fn is None:
            return 0
        cached = cached_fn()
        if not cached:
            return 0
        bs = int(rep.engine.bs)
        chain = hash_cache.get(bs)
        if chain is None:
            chain = hash_cache[bs] = prompt_block_hashes(
                req.prompt + req.generated, bs)
        score = 0
        for h in chain:
            if h not in cached:
                break
            score += 1
        return score

    def _pick_replica(self, req: _FrontendRequest,
                      live: List[_Replica]) -> Optional[_Replica]:
        fits = []
        for rep in live:
            if not self._fits_at_all(rep, req):
                continue
            slots, blocks = self._headroom(rep)
            if slots >= 1 and blocks >= _blocks_needed(rep.engine,
                                                       req.total_tokens):
                fits.append(rep)
        if not fits:
            return None
        n = len(self._replicas)
        hcache: Dict[int, List[str]] = {}
        best = min(fits, key=lambda r: (
            -self._prefix_affinity(r, req, hcache),       # most cached prefix
            len(r.requests) + len(r.engine._queue),      # then least loaded
            -self._headroom(r)[1],                        # then most free
            (r.idx - self._rr) % n))                      # then round-robin
        self._rr = (best.idx + 1) % n
        return best

    def _preempt_for(self, req: _FrontendRequest,
                     live: List[_Replica]) -> Optional[_Replica]:
        """Find a replica where evicting strictly-lower-priority running
        sequences frees enough blocks for ``req``; evict the minimal set
        (lowest class first, youngest first) and return the replica."""
        best = None  # (evictions, -free_after, rep, victims)
        for rep in live:
            if not self._fits_at_all(rep, req):
                continue
            need = _blocks_needed(rep.engine, req.total_tokens)
            victims = sorted(
                [fr for fr in rep.requests.values()
                 if int(fr.priority) > int(req.priority)
                 and fr.engine_rid in rep.engine._active],
                key=lambda f: (-int(f.priority), -f.seq))
            slots, blocks = self._headroom(rep)
            take: List[_FrontendRequest] = []
            for v in victims:
                if slots >= 1 and blocks >= need:
                    break
                take.append(v)
                slots += 1
                blocks += len(rep.engine._active[v.engine_rid].blocks)
            if slots >= 1 and blocks >= need and take:
                cand = (len(take), -blocks, rep.idx, rep, take)
                if best is None or cand[:3] < best[:3]:
                    best = cand
        if best is None:
            return None
        _, _, _, rep, take = best
        for v in take:
            if not self._preempt(v):
                return None    # replica died mid-eviction; failover ran
        return rep

    def _preempt(self, victim: _FrontendRequest) -> bool:
        """Evict ``victim`` and re-queue it; False if its replica faulted
        (failover then already re-queued everything on it)."""
        rep = victim.replica
        try:
            rep.engine.evict(victim.engine_rid)
        except KeyError:
            pass  # retired between planning and eviction; slot is free
        except StaleEpoch as e:
            self._fenced(e, rep)
        except Exception as e:  # noqa: BLE001 — remote replica fault
            self._kill_replica(rep, e)
            return False
        rep.requests.pop(victim.engine_rid, None)
        victim.replica = None
        victim.engine_rid = None
        victim.preemptions += 1
        if self.tracer is not None and victim.trace is not None:
            self.tracer.event(victim.trace, "preempt",
                              tokens=len(victim.generated))
        self.metrics.inc("preempted_total")
        # re-queued with prompt+generated as the new prefill; keeps its
        # original seq so it resumes ahead of younger peers in its class
        self._queue.append(victim)
        return True

    def _assign(self, req: _FrontendRequest, rep: _Replica):
        if req.remaining_new_tokens <= 0:
            self._finish(req, RequestStatus.COMPLETED)
            return
        prefill = req.prompt + req.generated
        # a prefill PASS runs the prompt through attention and stops: one
        # sampled token (discarded at harvest) is the cheapest way to make
        # the engine compute + publish every full prompt block
        mnt = 1 if req.prefill_pass else req.remaining_new_tokens
        extra = {}
        if self.tracer is not None and req.trace is not None:
            # one child span per dispatch: engine/worker events for THIS
            # placement land on the attempt span, so a failover or
            # preemption re-dispatch shows up as a new attempt in the tree
            ctx = req.trace.child(f"attempt-{req.assignments + 1}")
            self.tracer.event(ctx, "dispatch", replica=rep.idx,
                              attempt=req.assignments + 1)
            extra["trace"] = ctx.to_wire()
        try:
            # sampling params travel as the dict wire form (RemoteReplica
            # ships them over RPC verbatim); sample_offset continues the
            # seeded key stream where a preempted/failed-over run stopped
            if req.deadline_t is not None:
                # forward the REMAINING deadline so the engine can freeze
                # the row in-graph at its budget — relative
                # seconds, same wire form the journal uses, because the
                # engine keeps its own clock
                extra["deadline_s"] = req.deadline_t - self._clock()
            erid = rep.engine.add_request(
                prefill, max_new_tokens=mnt,
                eos_token_id=req.eos_token_id,
                sampling=req.sampling.to_wire(),
                sample_offset=len(req.generated), **extra)
        except ValueError as e:
            # e.g. an int8 engine whose one-shot-prefill contract a resumed
            # (grown) prefill no longer satisfies
            self._finish(req, RequestStatus.OVERLOADED,
                         f"engine rejected request: {e}")
            return
        except StaleEpoch as e:
            # the request stays queued untouched: the successor already
            # owns it (recovered from the journal) — nothing to do here
            # but stop being a zombie
            self._queue.append(req)
            self._fenced(e, rep)
        except Exception as e:  # noqa: BLE001 — remote replica fault
            # a worker that died between heartbeats surfaces here when
            # dispatch tries to place on it: fail over (re-queues its
            # in-flight requests) and retry this one on a survivor —
            # through the same retry budget as a mid-step death, so a
            # request that kills replicas at admission quarantines too
            self._kill_replica(rep, e)
            self._requeue_or_quarantine(req, rep)
            return
        rep.requests[erid] = req
        req.replica = rep
        req.engine_rid = erid
        if req.assignments > 0:
            self.metrics.inc("resumed_total")
        req.assignments += 1

    def _step_replica(self, rep: _Replica):
        try:
            emitted = rep.engine.step()
        except StaleEpoch as e:
            # a fenced step is the worker saying "you are deposed", not a
            # replica fault: no kill, no re-queue (the new incarnation
            # owns these requests — re-queueing would double-execute)
            self._fenced(e, rep)
        except Exception as e:  # noqa: BLE001 — any replica fault fails over
            self._kill_replica(rep, e)
            return
        self.metrics.inc("engine_steps_total")
        lp_fn = getattr(rep.engine, "pop_token_logprobs", None)
        lps = lp_fn() if lp_fn is not None else {}
        if getattr(rep.engine, "capture_sample_probs", False):
            # the frontend has no per-token consumer for the [V]-sized
            # distributions — drain them so a capture-enabled engine
            # driven by a long-lived frontend doesn't accumulate one
            # array per emitted token forever (spec-decode verifiers
            # harvest by driving the engine directly)
            rep.engine.pop_sample_probs()
        t = self._clock()
        for erid, toks in emitted.items():
            req = rep.requests.get(erid)
            if req is None:
                continue
            if not toks:
                continue
            if req.prefill_pass:
                # the pass's sampled token is scaffolding, not output —
                # decode re-emits it token-identically (sample_offset=0
                # restarts the seeded stream from the same prefix)
                continue
            # weights-version attribution: stamp the version
            # that generated THIS burst — last writer wins, so a request
            # completing entirely on one version reports exactly it
            req.weights_version = getattr(rep.engine, "weights_version",
                                          None)
            tid = req.trace.trace_id if req.trace is not None else None
            if req.first_token_t is None:
                req.first_token_t = t
                self.metrics.observe("ttft_seconds", t - req.submit_t,
                                     trace_id=tid)
            elif req.last_token_t is not None:
                # inter-token latency: a megastep delivers its K tokens in
                # one burst, so the per-token value is the boundary-to-
                # boundary gap amortized over the burst
                self.metrics.observe(
                    "token_latency_seconds",
                    (t - req.last_token_t) / len(toks), trace_id=tid)
            req.last_token_t = t
            req.generated.extend(toks)
            if req.sampling.logprobs:
                req.logprob_values.extend(lps.get(erid, ()))
            if req.on_token is not None:
                try:
                    for tok in toks:
                        req.on_token(req.rid, tok)
                except Exception:  # noqa: BLE001 — caller bug, not ours
                    # a raising stream callback must not kill the replica
                    # or wedge the step loop: disable it for this request
                    req.on_token = None
                    self.metrics.inc("stream_callback_errors_total")
            self.metrics.note_tokens(len(toks), t)
            if req.admitted and self._journaling:
                # megastep-boundary progress marker, group-committed at
                # the end of this step(): observability, the live retry-
                # budget count, and the REMAINING deadline (recovery
                # re-prefills from the prompt — tokens replay — but
                # attempts and the SLO clock must survive the crash)
                self._step_records.append(self._progress_record(req))
        for erid in rep.engine.pop_finished():
            req = rep.requests.pop(erid, None)
            if req is None:
                continue
            req.replica = None
            req.engine_rid = None
            if req.prefill_pass:
                # not a terminal: the pass computed + cached the prompt's
                # KV; publish the chain, stream it to a decode replica,
                # then hand the request over for the real generation
                self._complete_prefill_pass(req, rep)
                continue
            self._finish(req, RequestStatus.COMPLETED)

    def _complete_prefill_pass(self, req: _FrontendRequest, rep: _Replica):
        """Prefill pass finished on ``rep``: publish the prompt's block
        chain to the directory, push the blocks to the decode replica that
        will own the request, release the dedup claim, and dispatch the
        request for real.  The pull target is RE-PLANNED when the chosen
        decode replica dies between prefill completion and admission: drop
        the corpse from the
        candidate pool and pick another live decode replica — parity is
        untouched because pulled blocks are bit-exact wherever they
        land.  Any remaining fault (injected fabric.publish/pull, every
        candidate dead) degrades to recompute: the request re-queues and
        decode admission simply misses the cache."""
        req.prefill_pass = False
        key, req.fabric_key = req.fabric_key, None
        name = self._replica_name(rep)
        hashes = prompt_block_hashes(req.prompt, int(rep.engine.bs))
        live = [r for r in self._replicas if r.alive and not r.draining]
        pool = [r for r in self._decode_pool(live) if r is not rep]
        target: Optional[_Replica] = None
        try:
            self.fabric.publish_chain(name, hashes, epoch=self.epoch)
            while pool:
                target = self._pick_replica(req, pool)
                if target is None:
                    break         # nothing fits right now → queue + recompute
                try:
                    cached_fn = getattr(target.engine,
                                        "cached_block_hashes", None)
                    cached = cached_fn() if cached_fn is not None else set()
                    missing = [h for h in hashes if h not in cached]
                    n, nbytes, transport = self.fabric.pull(
                        rep.engine, target.engine, missing, owner=name,
                        epoch=self.epoch)
                    self._note_transport(req, transport, n, nbytes,
                                         self._replica_name(target))
                    if self.tracer is not None and req.trace is not None:
                        self.tracer.event(req.trace, "block_transfer",
                                          blocks=n, bytes=nbytes, src=name,
                                          dst=self._replica_name(target))
                    break
                except StaleEpoch:
                    raise         # outer handler: deposed-path recompute
                except Exception:  # noqa: BLE001 — chosen target died
                    self.metrics.inc("fabric_pull_failures_total")
                    self.metrics.inc("fabric_replans_total")
                    pool = [r for r in pool
                            if r is not target and r.alive]
                    target = None
            if target is None and not pool:
                # every candidate failed (or none existed): recompute
                self.metrics.inc("fabric_recomputes_total")
        except StaleEpoch:
            self.metrics.inc("fabric_recomputes_total")
            target = None
        except Exception:  # noqa: BLE001 — fabric fault → recompute
            self.metrics.inc("fabric_pull_failures_total")
            self.metrics.inc("fabric_recomputes_total")
            target = None
        finally:
            if key is not None:
                self.fabric.finish_prefill(key)
        if target is not None:
            self._assign(req, target)
        else:
            self._queue.append(req)

    def _kill_replica(self, rep: _Replica, exc: BaseException):
        rep.alive = False
        rep.last_error = repr(exc)
        self.metrics.inc("replica_deaths_total")
        # the engine's device state is untrusted after a fault; resume every
        # in-flight request from host-side state on a surviving replica —
        # UNLESS its retry budget is spent: a request whose replica died
        # max_request_retries+1 times is overwhelmingly likely to be the
        # poison that killed them, and re-queueing it would cascade the
        # crash through every survivor in turn.  Quarantine it typed.
        for erid, req in list(rep.requests.items()):
            req.replica = None
            req.engine_rid = None
            if self.tracer is not None and req.trace is not None:
                self.tracer.event(req.trace, "replica_death",
                                  replica=rep.idx)
            self._requeue_or_quarantine(req, rep)
        rep.requests.clear()

    def _requeue_or_quarantine(self, req: _FrontendRequest, rep: _Replica):
        """Charge one replica death against ``req``'s retry budget: back
        to the queue within budget, typed FAILED_POISON past it."""
        if req.prefill_pass:
            # the pass died with its replica (prefill-worker-dies-mid-
            # stream): release the claim so a twin can proceed, and let
            # the re-queued request recompute on a decode replica — its
            # prefill_passes budget is already spent
            req.prefill_pass = False
            if req.fabric_key is not None and self.fabric is not None:
                self.fabric.finish_prefill(req.fabric_key)
                req.fabric_key = None
        req.attempts += 1
        if req.attempts > self.max_request_retries:
            self._finish(
                req, RequestStatus.FAILED_POISON,
                f"quarantined: replica died {req.attempts} times with "
                f"this request in flight (max_request_retries="
                f"{self.max_request_retries}); last error: "
                f"{rep.last_error}")
            return
        self._queue.append(req)
        if self.tracer is not None and req.trace is not None:
            self.tracer.event(req.trace, "retry", attempts=req.attempts)
        # make the bumped retry budget durable NOW (not batched) — a
        # crash before the request's next harvested token would
        # otherwise hand a poison request a fresh budget on recovery
        if req.admitted:
            self._journal_append(self._progress_record(req))
        self.metrics.inc("requeued_on_failover_total")
        self.metrics.inc("requests_retried_total")

    def _finish(self, req: _FrontendRequest, status: RequestStatus,
                detail: str = "") -> RequestResult:
        # first terminal state wins: a request quarantined inside
        # _kill_replica during a cancel/shed evict fault must not be
        # re-finished (and double-counted) by the outer path
        prev = self._results.get(req.rid)
        if prev is not None:
            return prev
        if req.fabric_key is not None and self.fabric is not None:
            # a terminal (deadline shed, cancel, quarantine) mid-prefill-
            # pass must release the dedup claim or identical prompts wait
            # on a corpse until the claim's epoch goes stale
            self.fabric.finish_prefill(req.fabric_key)
            req.fabric_key = None
            req.prefill_pass = False
        if status is RequestStatus.COMPLETED and req.capped_from is not None:
            detail = (f"brownout: max_new_tokens capped "
                      f"{req.capped_from} -> {req.max_new_tokens}")
        now = self._clock()
        res = RequestResult(
            rid=req.rid, status=status, tokens=list(req.generated),
            detail=detail, preemptions=req.preemptions,
            attempts=req.attempts,
            ttft_s=(req.first_token_t - req.submit_t)
            if req.first_token_t is not None else None,
            e2e_s=now - req.submit_t,
            logprobs=(list(req.logprob_values) if req.sampling.logprobs
                      else None),
            weights_version=req.weights_version, tenant=req.tenant)
        self._results[req.rid] = res
        if self.tracer is not None:
            if req.trace is None:
                # typed rejections never pass admission; mint here so
                # EVERY typed terminal owns a complete span tree
                req.trace = self.tracer.begin(req.rid)
                self.tracer.event(req.trace, "submit")
            term_extra = {}
            if req.weights_version is not None:
                term_extra["weights_version"] = req.weights_version
            if req.tenant is not None:
                term_extra["tenant"] = req.tenant
            self.tracer.event(req.trace, "terminal", status=status.value,
                              tokens=len(req.generated),
                              attempts=req.attempts, **term_extra)
            self.tracer.note_terminal(req.trace, status.value,
                                      e2e_s=res.e2e_s)
        if req.counted_tokens:
            self._class_tokens[req.priority] -= req.counted_tokens
            if self.tenants is not None and req.tenant is not None:
                self.tenants.release(req.tenant, req.counted_tokens)
            req.counted_tokens = 0
        if self.tenants is not None and req.tenant is not None:
            # per-tenant served-token attribution: dynamic counter names
            # ride the open runtime registry (tenant_<name>_served_
            # tokens_total) — the tenant_isolation bench rung reads the
            # registry's ratio, not wall-clock
            self.tenants.note_served(req.tenant, len(req.generated))
            if req.generated:
                self.metrics.inc(
                    f"tenant_{self.tenants.resolve(req.tenant)}"
                    f"_served_tokens_total", len(req.generated))
        if req.admitted:
            # exactly one typed terminal record per admitted rid (the
            # first-terminal-wins guard above makes this exact); tokens
            # ride only as a count — they replay, they are not journaled.
            # In-step completions ride the step's group commit (durable
            # before the result is observable — step() flushes before
            # returning); out-of-step finishes (cancel, shed at submit
            # time) append immediately
            rec = {"t": TERMINAL, "rid": req.rid, "status": status.value,
                   "n_tokens": len(req.generated), "attempts": req.attempts,
                   "key": req.idempotency_key, "nr": self._next_rid}
            if self._in_step and self._journaling:
                self._step_records.append(rec)
            else:
                self._journal_append(rec)
        if req.idempotency_key is not None and req.admitted:
            # only ADMITTED requests claim their key (a typed rejection
            # never executed, so a client retry must re-attempt for real)
            self._idem_open.pop(req.idempotency_key, None)
            self._idem_done[req.idempotency_key] = req.rid
            while len(self._idem_done) > self.idempotency_cache_size:
                self._idem_done.popitem(last=False)
        self.metrics.inc(_STATUS_COUNTER[status])
        if status is RequestStatus.COMPLETED:
            self.metrics.observe("e2e_latency_seconds", res.e2e_s,
                                 trace_id=(req.trace.trace_id
                                           if req.trace is not None
                                           else None))
        return res

    def _sample_gauges(self):
        m = self.metrics
        live = [r for r in self._replicas if r.alive]
        m.set_gauge_peak("queue_depth", len(self._queue))
        m.set_gauge("running_requests", sum(len(r.requests) for r in live))
        m.set_gauge("replicas_alive", len(live))
        total = sum(r.engine.blocks.num_blocks for r in live)
        free = sum(r.engine.blocks.num_free for r in live)
        m.set_gauge("blocks_capacity", total)
        m.set_gauge("blocks_free", free)
        m.set_gauge_peak("block_pool_utilization",
                         (1.0 - free / total) if total else 0.0)
        # per-phase step-time attribution: cumulative
        # host seconds summed over live replicas, same aggregation shape
        # as the block gauges above
        sched = exe = harv = 0.0
        for rep in live:
            ps = getattr(rep.engine, "phase_seconds", None)
            if ps:
                sched += float(ps.get("schedule", 0.0))
                exe += float(ps.get("execute", 0.0))
                harv += float(ps.get("harvest", 0.0))
        m.set_gauge("step_phase_schedule_seconds", sched)
        m.set_gauge("step_phase_execute_seconds", exe)
        m.set_gauge("step_phase_harvest_seconds", harv)
        if self.fabric is not None:
            # directory/transfer counters, exported as gauges (they are
            # fabric-cumulative, not frontend deltas)
            for k, v in self.fabric.counters.items():
                m.set_gauge(f"fabric_{k}", float(v))
        if self.tenants is not None:
            # per-tenant outstanding-token gauges (budget observability);
            # dynamic names ride the open runtime registry
            for tname, st in self.tenants.snapshot().items():
                m.set_gauge(f"tenant_{tname}_outstanding_tokens",
                            st["outstanding"])
        for rep in live:
            eng = rep.engine
            if getattr(eng, "prefix_counters_self_reported", False):
                # RemoteReplica mirrors counters the worker's own registry
                # already exports on the fleet scrape page — folding the
                # mirror here would double-count them fleet-wide
                continue
            cur = (int(getattr(eng, "prefix_hit_blocks", 0)),
                   int(getattr(eng, "prefix_miss_blocks", 0)),
                   int(getattr(eng, "prefix_evictions", 0)))
            rep.prefix_seen = fold_prefix_counters(m, cur, rep.prefix_seen)
            mcur = (int(getattr(eng, "megasteps", 0)),
                    int(getattr(eng, "megastep_tokens", 0)),
                    int(getattr(eng, "megasteps_mixed", 0)),
                    int(getattr(eng, "prefill_chunks", 0)))
            rep.mega_seen = fold_counter_deltas(m, MEGASTEP_COUNTERS, mcur,
                                                rep.mega_seen)
            scur = (int(getattr(eng, "spec_accepted_tokens", 0)),
                    int(getattr(eng, "spec_draft_tokens", 0)),
                    int(getattr(eng, "spec_verify_forwards", 0)))
            rep.spec_seen = fold_counter_deltas(m, SPEC_COUNTERS, scur,
                                                rep.spec_seen)
