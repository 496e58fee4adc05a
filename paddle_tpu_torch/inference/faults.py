"""Deterministic fault injection + containment primitives for the
serving fleet (reference analogs: freebsd/etcd-style failpoints for the
injection side, the classic Netflix/Hystrix breaker state machine for
containment — rebuilt host-side and seeded so chaos runs are exactly
reproducible).

Three pieces:

* **``FaultInjector``** — a seeded failpoint registry.  Production code
  carries *named sites* (``engine.step``, ``engine.megastep`` — the
  batched K-token decode path, fired at megastep launch so a fault never
  leaves half-committed tokens — ``rpc.send``, ``health.probe``,
  ``fleet.spawn``, ``fleet.heartbeat``) as one-line hooks that are
  zero-cost when no injector is armed (the default is ``None`` unless the
  ``PADDLE_TPU_FAULTS`` env var carries a JSON spec).  Each armed site
  has a ``FaultSpec`` — kind (``error``/``timeout``/``drop``/``delay``),
  probability, skip-count, fire-budget, and an optional ``match``
  substring against the site's detail string (how a *poison request* is
  expressed: match on its prompt signature and the fault follows the
  request across replicas and resumes).  Randomness is a per-site
  ``random.Random`` seeded from ``(seed, site)``, so fire schedules are
  independent of cross-site interleaving and reproducible across
  processes — the chaos soak's whole contract.
* **``RespawnCircuitBreaker``** — the containment for a crash-looping
  spawner: K failures (spawn faults or early deaths) inside a sliding
  window open the breaker; while open, ``allow()`` refuses respawns
  until an exponentially-growing, jittered backoff elapses, then admits
  exactly ONE half-open probe — probe success re-closes, probe failure
  re-opens with doubled backoff.  Clock and jitter RNG are injectable
  so tests drive the state machine deterministically.
* **``FaultyReplica``** — an engine-surface proxy that fires injector
  sites around ``step``/``add_request``/``evict``: how the chaos harness
  (``tools/chaos_serving.py``) and the fast fault-containment tests make
  in-process replicas fail exactly like remote workers (crash, hang past
  the RPC deadline, drop the connection) without subprocess boots.

Nothing here imports jax or the engine — pure host-side stdlib, safe to
import from ``distributed/rpc`` without cycles.
"""
from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

__all__ = [
    "FaultSpec", "FaultInjector", "InjectedFault", "InjectedTimeout",
    "InjectedDrop", "RespawnCircuitBreaker", "FaultyReplica",
    "FAULTS_ENV_VAR", "KNOWN_SITES", "register_failpoint",
    "REPLICA_NAMESPACES", "register_replica_namespace",
]

FAULTS_ENV_VAR = "PADDLE_TPU_FAULTS"

# Every failpoint site production code traverses.  FaultInjector
# VALIDATES armed site names against this registry at construction
# time: a typo'd site in PADDLE_TPU_FAULTS or a chaos
# schedule used to arm successfully and then never fire — a chaos run
# that silently degraded to calm.  New instrumented components extend
# the registry with ``register_failpoint`` next to the code that fires
# the site, so the two lists cannot drift apart.
KNOWN_SITES = {
    "engine.step",        # ServingEngine.step scheduling boundary
    "engine.megastep",    # batched K-token decode launch
    "engine.prefill_chunk",  # prompt-chunk feed boundary:
    #                       fired per chunk the scheduler commits —
    #                       single-step prefill feeds AND rows packed
    #                       into a mixed-phase megastep launch
    "engine.add_request",  # FaultyReplica admission path
    "engine.evict",       # FaultyReplica eviction path
    "rpc.send",           # distributed/rpc._post transport
    "health.probe",       # worker-side _w_health handler
    "fleet.spawn",        # ServingFleet worker registration wait
    "fleet.heartbeat",    # fleet-side heartbeat loop
    "journal.append",     # request-journal record write
    "journal.fsync",      # request-journal durability barrier
    # HA control plane — canonical registrations live next
    # to the firing code in inference/ha.py / control_plane.handoff;
    # listed here too so an env-armed injector in a process that never
    # imports the HA stack still validates them
    "lease.acquire",      # FrontendLease.acquire (standby takeover)
    "lease.renew",        # FrontendLease.renew (active heartbeat)
    "handoff.flush",      # ServingFrontend.handoff final snapshot
    # disaggregated KV fabric — canonical registrations live
    # next to the firing code in inference/kv_fabric.py; listed here too
    # so env-armed injectors validate without importing the fabric
    "fabric.publish",     # prefill worker dies before its chain lands
    "fabric.pull",        # decode pulls blocks from a dead peer
    "fabric.directory",   # directory reads, incl. stale-lease rejection
    # binary KV data plane — canonical registration lives
    # next to the firing code in inference/blockwire.py: the listener
    # faults a pull mid-handshake (typed error frame back; the puller
    # degrades to the frontend relay, then recompute)
    "fabric.wire",        # data-plane pull request on the serving side
    # multi-tenant elastic platform — canonical registrations
    # live next to the firing code (serving.load_weights, fleet.WarmPool);
    # listed here too so env-armed injectors validate everywhere
    "weights.swap",       # engine swaps in a new weights version
    "pool.attach",        # warm worker claimed + attached to the fleet
    "pool.refill",        # warm pool spawns a replacement worker
    # speculative decoding — canonical registrations live
    # next to the firing code in inference/serving.py; a fault at either
    # site degrades to the non-spec path, never a wrong token
    "engine.spec_draft",  # host-side n-gram drafter, fired per drafted row
    "engine.spec_verify",  # batched multi-token verify launch
}
# FaultyReplica/FencedEngine also fire replica-scoped sites
# "<replica name>.<op>" (so a schedule can doom one replica).  The
# NAMESPACE must be registered (register_replica_namespace, the
# constructor/env "replica_namespaces" lists, or wrapping a
# FaultyReplica with that name) — closing the hole where a
# namespace typo whose op suffix was legal ("enigne.step") armed
# silently and the chaos run degraded to calm.
#
# REPLICA_NAMESPACES is the process-global DEFAULT registry (grow-only:
# wrap-first-arm-later and register-up-front both need registrations to
# outlive any one injector).  That default leaks across runs — a later
# injector in the same process would validate against every name an
# earlier run registered, so a stale copy-paste site like "r0.step"
# armed silently if some previous schedule ever spawned an "r0".
# Run-scoped validation closes it: pass a
# ``namespace_registry=`` set to FaultInjector / FaultyReplica /
# register_replica_namespace and every registration + arm-time check
# for that run stays inside the handle (tools/chaos_serving.py threads
# one per soak).
_REPLICA_OPS = {"step", "add_request", "evict"}
REPLICA_NAMESPACES: set = set()


def register_failpoint(site: str) -> str:
    """Add ``site`` to the known-site registry (call next to the code
    that fires it).  Returns the name so registration can double as the
    site constant: ``MY_SITE = register_failpoint("cache.flush")``."""
    KNOWN_SITES.add(site)
    return site


def register_replica_namespace(name: str,
                               registry: Optional[set] = None) -> str:
    """Allow ``<name>.<op>`` replica-scoped sites (op in step /
    add_request / evict) to arm.  Chaos harnesses register the replica
    names they plan to spawn BEFORE building the injector;
    ``FaultyReplica`` registers its own name at construction for the
    wrap-first-arm-later order.  Returns the name.

    ``registry`` scopes the registration: None lands in the
    process-global :data:`REPLICA_NAMESPACES`; a run-scoped set keeps
    one chaos run's names from validating a later run's typos."""
    (REPLICA_NAMESPACES if registry is None else registry).add(name)
    return name


class InjectedFault(RuntimeError):
    """kind='error': the failure a crashing component would raise."""


class InjectedTimeout(TimeoutError):
    """kind='timeout' when the site supplies no typed exception (RPC
    sites pass ``timeout_exc=RpcTimeout`` so callers see the exact type
    a genuinely hung peer produces)."""


class InjectedDrop(ConnectionResetError):
    """kind='drop': peer vanished mid-call (SIGKILL, network partition)."""


@dataclass
class FaultSpec:
    """One armed failpoint.

    ``kind``: ``error`` raises :class:`InjectedFault`; ``timeout`` raises
    the site's typed timeout (or :class:`InjectedTimeout`); ``drop``
    raises :class:`InjectedDrop`; ``delay`` sleeps ``delay_s`` and lets
    the call proceed.  ``p`` is the per-traversal fire probability
    (seeded), ``after`` skips the first N matching traversals, ``times``
    bounds total fires (None = unbounded), ``match`` restricts the site
    to traversals whose detail string contains it (poison routing)."""

    kind: str
    p: float = 1.0
    after: int = 0
    times: Optional[int] = None
    delay_s: float = 0.0
    match: Optional[str] = None

    KINDS = ("error", "timeout", "drop", "delay")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"FaultSpec.kind must be one of {self.KINDS}, "
                             f"got {self.kind!r}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"FaultSpec.p must be in [0, 1], got {self.p}")


class FaultInjector:
    """Seeded registry of named failpoints.

    >>> inj = FaultInjector({"engine.step": {"kind": "error", "p": 0.1}},
    ...                     seed=7)
    >>> inj.fire("engine.step")        # raises InjectedFault ~10% of hits
    >>> inj.fire("unarmed.site")       # no spec: returns False, free

    Sites with no spec cost one dict lookup; production components only
    reach that lookup when an injector was explicitly armed (constructor
    arg or the ``PADDLE_TPU_FAULTS`` env JSON), so the default serving
    path carries zero overhead."""

    def __init__(self, sites: Dict[str, Union[FaultSpec, Dict]],
                 seed: int = 0, sleep: Callable[[float], None] = time.sleep,
                 replica_namespaces: Iterable[str] = (),
                 namespace_registry: Optional[set] = None):
        self.seed = int(seed)
        self._sleep = sleep
        # run-scoped namespace validation: with
        # a registry handle, this injector neither sees nor pollutes the
        # process-global set, so arm-time validation cannot be satisfied
        # by a name some EARLIER same-process run registered
        self._ns_registry = namespace_registry
        for ns in replica_namespaces:
            register_replica_namespace(ns, registry=namespace_registry)
        for site in (sites or {}):
            self._validate_site(site)
        self._specs: Dict[str, FaultSpec] = {
            site: spec if isinstance(spec, FaultSpec) else FaultSpec(**spec)
            for site, spec in (sites or {}).items()}
        # one RNG per site, seeded by (seed, site): a site's fire schedule
        # depends only on its own traversal count, never on how other
        # sites interleave — the reproducibility contract chaos runs need
        self._rng: Dict[str, random.Random] = {
            site: random.Random(f"{self.seed}:{site}") for site in self._specs}
        self._traversals: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}
        self.log: List[Tuple[str, str, str]] = []  # (site, kind, detail)
        # optional tracing.FlightRecorder: armed by chaos
        # harnesses so every injected fault lands in the flight recorder
        # next to the lifecycle events it perturbed
        self.recorder = None

    def _namespaces(self) -> set:
        """The namespace registry THIS injector validates against: its
        run-scoped handle when one was passed, else the process-global
        default (resolved at call time so tests can swap the module
        attribute)."""
        return (self._ns_registry if self._ns_registry is not None
                else REPLICA_NAMESPACES)

    def _validate_site(self, site: str):
        """Arm-time check against the known-site registry: a site no
        production code fires would otherwise arm fine and never fire —
        a chaos schedule (or PADDLE_TPU_FAULTS) silently degrading to
        calm.  Both the constructor and the env-JSON path funnel here."""
        if site in KNOWN_SITES:
            return
        namespaces = self._namespaces()
        if "." in site:
            ns, op = site.rsplit(".", 1)
            # replica-scoped "<name>.<op>": BOTH halves validate — the
            # op against the fixed replica surface, the namespace
            # against the registered set, so "typo-replica.step" raises
            # here instead of silently never firing
            if op in _REPLICA_OPS and ns in namespaces:
                return
            if op in _REPLICA_OPS:
                raise ValueError(
                    f"failpoint site {site!r} has a replica-op suffix but "
                    f"unregistered namespace {ns!r}: nothing would fire "
                    "it. Register planned replica names first "
                    "(faults.register_replica_namespace, the injector's "
                    "replica_namespaces= argument, or the env spec's "
                    '"replica_namespaces" list); currently registered: '
                    f"{sorted(namespaces)}")
        raise ValueError(
            f"unknown failpoint site {site!r}: nothing fires it, so the "
            "spec would never trigger. Known sites: "
            f"{sorted(KNOWN_SITES)}; replica-scoped sites are "
            f"'<registered namespace>.<op>' with op in "
            f"{sorted(_REPLICA_OPS)}. New production sites register via "
            "faults.register_failpoint")

    @classmethod
    def from_env(cls, var: str = FAULTS_ENV_VAR) -> Optional["FaultInjector"]:
        """Injector from a JSON env spec, or None when unset — the
        production default every instrumented constructor falls back to.

        ``PADDLE_TPU_FAULTS='{"seed": 7, "sites": {"engine.step":
        {"kind": "error", "p": 0.05}}}'``"""
        raw = os.environ.get(var)
        if not raw:
            return None
        cfg = json.loads(raw)
        return cls(cfg.get("sites", {}), seed=cfg.get("seed", 0),
                   replica_namespaces=cfg.get("replica_namespaces", ()))

    def spec(self, site: str) -> Optional[FaultSpec]:
        return self._specs.get(site)

    def fires(self, site: str) -> int:
        """How many times ``site`` actually fired."""
        return self._fires.get(site, 0)

    @property
    def total_fires(self) -> int:
        return sum(self._fires.values())

    def kinds_fired(self) -> List[str]:
        """Distinct fault kinds that actually fired (the chaos soak
        asserts >= 3 so a 'chaos' run can't silently degrade to calm)."""
        return sorted({k for _, k, _ in self.log})

    def fire(self, site: str, detail: str = "",
             timeout_exc: Optional[type] = None) -> bool:
        """Traverse failpoint ``site``.  Returns False when the site is
        unarmed or the spec declines this traversal; otherwise performs
        the spec's action — sleeps for ``delay`` (returns True), raises
        for ``error``/``timeout``/``drop``."""
        spec = self._specs.get(site)
        if spec is None:
            return False
        if spec.match is not None and spec.match not in detail:
            return False
        n = self._traversals.get(site, 0) + 1
        self._traversals[site] = n
        if n <= spec.after:
            return False
        if spec.times is not None and self._fires.get(site, 0) >= spec.times:
            return False
        if spec.p < 1.0 and self._rng[site].random() >= spec.p:
            return False
        self._fires[site] = self._fires.get(site, 0) + 1
        self.log.append((site, spec.kind, detail))
        if self.recorder is not None:
            # trace-less process event: fault fires are flight-recorder
            # context, not request spans (the perturbed request's own
            # retry/replica_death events carry the request linkage)
            self.recorder.record(None, None, None, "fault",
                                 site=site, kind=spec.kind)
        msg = (f"injected {spec.kind} at failpoint '{site}'"
               + (f" ({detail})" if detail else ""))
        if spec.kind == "delay":
            self._sleep(spec.delay_s)
            return True
        if spec.kind == "timeout":
            raise (timeout_exc or InjectedTimeout)(msg)
        if spec.kind == "drop":
            raise InjectedDrop(msg)
        raise InjectedFault(msg)


class RespawnCircuitBreaker:
    """Spawn-path circuit breaker with exponential jittered backoff.

    Containment for the crash-looping-worker failure mode: without it a
    fleet whose worker *config* is broken respawns (and pays the ~10 s
    boot for) a doomed process on every autoscaler observation, forever.

    States: ``closed`` (spawns flow; ``threshold`` failures inside
    ``window_s`` open it) -> ``open`` (``allow()`` is False until the
    backoff deadline) -> ``half_open`` (exactly one probe spawn admitted;
    ``record_success`` re-closes and resets the backoff ladder,
    ``record_failure`` re-opens with the backoff doubled, up to
    ``max_backoff_s``).  Backoff is jittered ±``jitter`` relative via a
    seeded RNG so N breakers opened by one outage don't retry in
    lockstep, while staying reproducible under test."""

    def __init__(self, threshold: int = 3, window_s: float = 60.0,
                 base_backoff_s: float = 2.0, max_backoff_s: float = 120.0,
                 jitter: float = 0.25,
                 clock: Callable[[], float] = time.monotonic, seed: int = 0):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self._clock = clock
        self._rng = random.Random(f"breaker:{seed}")
        # the state machine locks ITSELF: the fleet's async boot threads
        # report failures while the control thread probes allow() and
        # records successes — callers get atomicity without knowing the
        # breaker is shared.  Re-entrant: the transition helpers below
        # run under the public methods' lock
        self._lock = threading.RLock()
        self.state = "closed"              # guarded-by: self._lock
        self.open_count = 0                # guarded-by: self._lock
        self._failures: List[float] = []   # guarded-by: self._lock
        self._consecutive_opens = 0        # guarded-by: self._lock
        self._retry_at = -float("inf")     # guarded-by: self._lock
        # optional tracing.FlightRecorder: breaker transitions
        # land in the flight recorder as trace-less process events
        self.recorder = None

    def _backoff(self) -> float:
        with self._lock:
            raw = min(self.base_backoff_s
                      * (2.0 ** (self._consecutive_opens - 1)),
                      self.max_backoff_s)
        return raw * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))

    def _open(self):
        with self._lock:
            self.state = "open"
            self.open_count += 1
            self._consecutive_opens += 1
            self._retry_at = self._clock() + self._backoff()
            self._failures.clear()
            if self.recorder is not None:
                self.recorder.record(None, None, None, "breaker_open",
                                     opens=self.open_count)

    def allow(self) -> bool:
        """May a spawn proceed right now?  An open breaker past its
        backoff deadline transitions to half-open and admits exactly one
        probe (callers MUST report that probe via record_success /
        record_failure, or the breaker stays half-open)."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open" and self._clock() >= self._retry_at:
                self.state = "half_open"
                return True
            return False   # open pre-deadline, or half-open probe out

    def record_failure(self) -> bool:
        """A spawn failed, or a just-spawned worker died early.  Returns
        True iff THIS call opened the breaker — the atomic transition
        signal callers count (two racing reporters must not both see
        closed→open and double-count ``breaker_open_total``)."""
        with self._lock:
            was_open = self.state == "open"
            if self.state == "half_open":
                self._open()           # probe failed: back off, doubled
                return not was_open
            now = self._clock()
            self._failures.append(now)
            cutoff = now - self.window_s
            self._failures = [t for t in self._failures if t >= cutoff]
            if self.state == "closed" \
                    and len(self._failures) >= self.threshold:
                self._open()
            return self.state == "open" and not was_open

    def record_success(self):
        """A spawned worker attached and looks healthy."""
        with self._lock:
            reopened = self.state != "closed"
            self.state = "closed"
            self._failures.clear()
            self._consecutive_opens = 0
            self._retry_at = -float("inf")
            if reopened and self.recorder is not None:
                self.recorder.record(None, None, None, "breaker_close")

    @property
    def open_gauge(self) -> float:
        """0 closed / 0.5 half-open / 1 open — the ``respawn_breaker_open``
        metrics gauge."""
        with self._lock:
            return {"closed": 0.0, "half_open": 0.5,
                    "open": 1.0}[self.state]


def prompt_signature(prompt, limit: int = 6) -> str:
    """Stable detail-string marker for one request's prompt — what a
    poison ``FaultSpec.match`` latches onto.  Uses the prompt HEAD, so a
    preempted/failed-over request resumed with ``prompt + generated`` as
    its new prefill keeps the same signature and the poison follows it
    across replicas (exactly how a deterministically-crashing input
    behaves in production).  EVERY token is terminated with ``-`` so a
    match anchors on token boundaries: ``match="p66-6-6-"`` fires on
    prompts headed ``[66, 6, 6]`` but never on ``[66, 6, 61]`` (whose
    signature is ``p66-6-61-``)."""
    return "p" + "".join(f"{int(t)}-" for t in list(prompt)[:limit])


class FaultyReplica:
    """Engine-surface proxy with failpoints at the frontend's driving
    calls — in-process stand-in for a remote worker that can crash, hang
    past its RPC deadline, or drop the connection.

    Fires two sites per call: the replica-specific ``{name}.{op}`` (a
    chaos schedule targets one replica) and the shared ``engine.{op}``
    (a poison spec matches any replica via the active prompts' signature
    in the detail string).  Everything else delegates to the wrapped
    engine, so admission/routing/preemption math sees real state."""

    def __init__(self, engine, injector: FaultInjector,
                 name: str = "replica", timeout_exc: Optional[type] = None,
                 namespace_registry: Optional[set] = None):
        self._eng = engine
        self._inj = injector
        # register into the same run-scoped registry the injector
        # validates against (wrap-first-arm-later order); defaults to
        # the injector's own handle so the pair cannot diverge
        if namespace_registry is None:
            namespace_registry = injector._ns_registry
        self.name = register_replica_namespace(
            name, registry=namespace_registry)
        self._timeout_exc = timeout_exc

    def __getattr__(self, attr):
        return getattr(self._eng, attr)

    def _detail(self) -> str:
        return " ".join(prompt_signature(r.prompt)
                        for r in self._eng._active.values())

    def _fire(self, op: str, detail: str):
        self._inj.fire(f"{self.name}.{op}", detail=detail,
                       timeout_exc=self._timeout_exc)
        self._inj.fire(f"engine.{op}", detail=detail,
                       timeout_exc=self._timeout_exc)

    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    eos_token_id=None, **kwargs):
        # sampling / sample_offset (and any future engine kwargs) pass
        # through untouched — the proxy only injects faults
        self._fire("add_request", prompt_signature(prompt_ids))
        return self._eng.add_request(prompt_ids,
                                     max_new_tokens=max_new_tokens,
                                     eos_token_id=eos_token_id, **kwargs)

    def step(self):
        self._fire("step", self._detail())
        return self._eng.step()

    def evict(self, rid):
        self._fire("evict", self._detail())
        return self._eng.evict(rid)
