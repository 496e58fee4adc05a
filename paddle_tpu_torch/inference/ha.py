"""High-availability control plane: lease-based leadership, monotone
fencing epochs, and automatic standby failover for the serving frontend
(reference analogs: the Chubby/GFS lease + fencing-token
pattern — leadership is a renewable lease, and every data-plane write
carries the holder's epoch so a deposed leader is REJECTED by the
storage/worker layer instead of being trusted to notice it lost — and
etcd-style lease records in a small KV store).

Copied from ``paddle_tpu/inference/ha.py`` (the port never imports the
JAX package); its lazy imports reach the port's own ``journal``,
``control_plane`` and ``distributed/launch/master.py``.

Four pieces, layered on the durability rails
(``ServingFrontend.recover`` over the WAL journal +
``fleet.discover_workers``):

* **``FrontendLease``** — one ``frontend-lease`` record (epoch, holder,
  expiry) in the launch KV master the fleet already registers with.
  ``acquire()`` takes an expired/released/absent lease at ``epoch+1``
  via the KV master's atomic compare-and-swap (two standbys racing for
  an expired lease cannot both win); ``renew()`` extends the holder's
  expiry with seeded-jittered retry backoff; ``release()`` expires the
  record EARLY while preserving the epoch counter (graceful handoff —
  the successor does not wait out the TTL).  Epochs are monotone across
  acquisitions forever: the epoch, not the holder name, is what workers
  fence on.
* **``EpochFence`` / ``StaleEpoch``** — the worker-side guard: the
  highest epoch ever seen wins, and a call carrying a LOWER epoch
  raises the typed :class:`StaleEpoch`.  This is what actually protects
  the data plane from a zombie frontend (SIGSTOP'd through its lease
  expiry, then resumed): the zombie cannot notice it was deposed, so
  the workers refuse it instead.  ``epoch=None`` callers pass unfenced
  (pre-HA compatibility; arm fencing by giving the frontend an epoch).
* **``FencedEngine``** — engine-surface proxy carrying a caller epoch
  through a shared ``EpochFence``: the in-process analog of a fenced
  worker, so the standby/zombie story is testable without subprocess
  boots (two frontend incarnations wrapping the SAME engines through
  the same fences).
* **``StandbyFrontend``** — the supervisor: watches the lease; when it
  expires (crash / zombie) or is released (handoff), acquires at
  ``epoch+1``, replays the journal through
  ``ServingFrontend.recover`` over freshly built/discovered replicas,
  and returns the new active frontend.  Takeovers are counted
  (``standby_takeovers_total``; expiry-triggered ones additionally in
  ``failovers_total``) so chaos gates are deterministic counters, not
  wall clock.

What the lease does and does NOT guarantee: holding it makes a
frontend the UNIQUE writer *as observed by the KV master* — but a
paused holder cannot see its own expiry, so the lease alone never
prevents split-brain.  Safety comes from the fencing epoch: every
control RPC a frontend issues carries its epoch, workers remember the
highest seen, and the first RPC from the new incarnation (the reap in
``recover``) fences every older epoch out.  The lease only arbitrates
WHO gets the next epoch.

Failpoints: ``lease.acquire``, ``lease.renew`` (fired per attempt on
their respective paths), and ``handoff.flush`` (fired by
``ServingFrontend.handoff`` before the final snapshot) — registered
here via :func:`~paddle_tpu_torch.inference.faults.register_failpoint`.

Nothing here imports torch or the engine — pure host-side stdlib (the KV
client is imported lazily), safe to import from anywhere in the
serving stack without cycles.
"""
from __future__ import annotations

import json
import random
import threading
import time
from typing import Callable, Dict, Optional

from .faults import FaultInjector, register_failpoint

__all__ = ["StaleEpoch", "EpochFence", "FencedEngine", "FrontendLease",
           "StandbyFrontend", "LEASE_KEY"]

LEASE_KEY = "/serving/frontend-lease"

LEASE_ACQUIRE = register_failpoint("lease.acquire")
LEASE_RENEW = register_failpoint("lease.renew")
HANDOFF_FLUSH = register_failpoint("handoff.flush")


class StaleEpoch(RuntimeError):
    """A control RPC carried an epoch older than the highest the worker
    has seen: the caller is a DEPOSED frontend (a zombie resumed after
    its lease expired, or one that missed its own handoff).  Terminal
    for the caller — stop stepping and let the new incarnation serve;
    never treated as a failover-able replica fault (the replica is
    fine, the *caller* is stale)."""


class EpochFence:
    """Monotone highest-epoch-seen guard (one per worker process /
    shared engine).  ``check(epoch)`` admits ``epoch >= highest`` and
    remembers it; a LOWER epoch raises :class:`StaleEpoch` and counts in
    ``fenced_total``.  ``epoch=None`` passes unfenced (pre-HA callers).
    Thread-safe: worker RPC handlers run in server threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.highest: Optional[int] = None   # guarded-by: self._lock
        self.fenced_total = 0                # guarded-by: self._lock

    def check(self, epoch: Optional[int], op: str = ""):
        if epoch is None:
            return
        epoch = int(epoch)
        with self._lock:
            if self.highest is not None and epoch < self.highest:
                self.fenced_total += 1
                raise StaleEpoch(
                    f"epoch {epoch} fenced at '{op or 'rpc'}': this worker "
                    f"has seen epoch {self.highest} — the caller is a "
                    "deposed frontend (zombie); stop stepping and defer to "
                    "the current incarnation")
            self.highest = epoch


class FencedEngine:
    """Engine-surface proxy that fences the frontend's driving calls
    (``add_request``/``step``/``evict``/``reap_orphans``) through a
    shared :class:`EpochFence` — the in-process analog of a fenced
    worker.  Two frontend incarnations wrap the SAME engine through the
    same fence; whichever carries the higher epoch wins, the other's
    calls raise :class:`StaleEpoch` before ever reaching the engine
    (zero duplicate token execution by construction).  The frontend
    stamps the caller epoch via ``set_epoch`` (same hook
    ``RemoteReplica`` exposes)."""

    def __init__(self, engine, fence: EpochFence,
                 epoch: Optional[int] = None):
        self._eng = engine
        self.fence = fence
        self.epoch = epoch

    def __getattr__(self, attr):
        return getattr(self._eng, attr)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    eos_token_id=None, **kwargs):
        self.fence.check(self.epoch, "add_request")
        return self._eng.add_request(prompt_ids,
                                     max_new_tokens=max_new_tokens,
                                     eos_token_id=eos_token_id, **kwargs)

    def step(self):
        self.fence.check(self.epoch, "step")
        return self._eng.step()

    def evict(self, rid):
        self.fence.check(self.epoch, "evict")
        return self._eng.evict(rid)

    def reap_orphans(self) -> int:
        self.fence.check(self.epoch, "reap_orphans")
        return self._eng.reap_orphans()


class FrontendLease:
    """Leadership lease for the serving control plane, stored in the
    launch KV master (the same store the fleet's workers register with).

    Record (compact JSON under ``key``):

        {"epoch": 3, "holder": "frontend-b", "expires": 171..., \
"released": false}

    * ``acquire()`` — take the lease at ``epoch+1`` iff it is absent,
      expired, or released; atomic via ``KVClient.cas`` so concurrent
      standbys cannot both win.  Returns the new epoch, or None.
    * ``renew()`` — extend the expiry; False means DEPOSED (the record
      now belongs to a higher epoch / different holder) and the caller
      must stop serving.  Transient CAS races / transport blips retry
      with seeded-jittered exponential backoff first.
    * ``release()`` — expire the record early, epoch PRESERVED (the
      counter must stay monotone forever); the graceful-handoff path
      that lets a successor take over without waiting out the TTL.

    ``clock`` must be comparable across processes (default
    ``time.time``); tests inject a counter clock for deterministic
    expiry.  The ``lease.acquire``/``lease.renew`` failpoints fire per
    call so chaos schedules can fault the leadership plane."""

    def __init__(self, master, key: str = LEASE_KEY, *,
                 ttl_s: float = 5.0, holder: Optional[str] = None,
                 clock: Callable[[], float] = time.time, seed: int = 0,
                 renew_retries: int = 3, retry_backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep,
                 fault_injector: Optional[FaultInjector] = None):
        if hasattr(master, "cas"):
            self._kv = master
        else:
            from ..distributed.launch.master import KVClient

            self._kv = KVClient(master)
        self.key = key
        self.ttl_s = float(ttl_s)
        import os as _os
        import socket as _socket

        # the default holder name must be unique across HOSTS, not just
        # processes: acquire()'s same-holder re-acquisition guard keys on
        # the name, and two containers both running as pid 1 with a bare
        # "frontend-{pid}" default would each be allowed to steal the
        # other's LIVE lease (leadership ping-pong with no fault
        # present).  Callers wanting deterministic identity (tests,
        # chaos replays, stable operator names) pass ``holder=``.
        self.holder = holder or (
            f"frontend-{_socket.gethostname()}-{_os.getpid()}-"
            f"{_os.urandom(4).hex()}")
        self._clock = clock
        self._sleep = sleep
        self.renew_retries = int(renew_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._rng = random.Random(f"lease:{seed}:{self.holder}")
        self._faults = (fault_injector if fault_injector is not None
                        else FaultInjector.from_env())
        self.epoch: Optional[int] = None   # epoch held, None = not holding
        self._held = False

    _UNSET = object()

    # --------------------------------------------------------------- state
    def read(self) -> Optional[Dict]:
        """Current lease record, or None when absent/unreadable."""
        return self._parse(self._kv.get(self.key))

    @staticmethod
    def _parse(raw: Optional[str]) -> Optional[Dict]:
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except ValueError:
            return None

    def live(self, rec=_UNSET, now: Optional[float] = None) -> bool:
        """Is the lease currently held (unexpired, unreleased)?  Pass an
        already-read ``rec`` (None meaning "absent") to judge THAT
        observation — an absent record is dead, never re-read here: the
        caller's subsequent CAS is what arbitrates races, and a re-read
        would judge a different state than the one the caller acts on."""
        if rec is self._UNSET:
            rec = self.read()
        now = self._clock() if now is None else now
        if rec is None or rec.get("released"):
            return False
        try:
            expires = float(rec.get("expires", 0.0))
        except (TypeError, ValueError):
            return False       # damaged record: dead, acquirable — a
        return expires > now   # raise here would wedge every standby

    @property
    def held(self) -> bool:
        return self._held

    # ------------------------------------------------------------ mutation
    def _write(self, raw_expect: Optional[str], rec: Dict) -> bool:
        return self._kv.cas(self.key, raw_expect,
                            json.dumps(rec, separators=(",", ":")))

    def acquire(self, min_epoch: Optional[int] = None) -> Optional[int]:
        """Take the lease at the next epoch iff it is free.  Returns the
        acquired epoch, or None (still live under another holder, lost
        the CAS race, or KV unreachable).

        ``min_epoch`` is the caller's known epoch FLOOR (typically the
        journal's recorded writer epoch): epochs must stay monotone
        FOREVER, but the lease record alone can't guarantee that — if it
        is lost (KV master restart, operator deletes the key, corrupt
        record) a bare acquire would restart at epoch 1, deposing the
        healthy active backwards and being refused by every journal and
        worker fence.  With a floor, acquisition resumes at
        ``min_epoch + 1`` instead."""
        if self._faults is not None:
            self._faults.fire("lease.acquire", detail=self.holder)
        raw = self._kv.get(self.key)
        rec = self._parse(raw)
        now = self._clock()
        # judge exactly the observed record (an absent one is simply
        # free — no re-read: a rival's CAS landing between this read and
        # ours below just makes OUR cas fail, which is the clean loss)
        if self.live(rec, now) and rec.get("holder") != self.holder:
            return None
        # a damaged-but-valid-JSON record (missing/garbage epoch) must
        # not wedge acquisition with a raise — treat it like an absent
        # record and let min_epoch (the journal floor) keep monotonicity
        try:
            prev = int(rec.get("epoch", 0)) if rec is not None else 0
        except (TypeError, ValueError):
            prev = 0
        epoch = prev + 1
        if min_epoch is not None:
            epoch = max(epoch, int(min_epoch) + 1)
        ok = self._write(raw, {"epoch": epoch, "holder": self.holder,
                               "expires": now + self.ttl_s,
                               "released": False})
        if not ok:
            return None        # raced — the winner's epoch is now live
        self.epoch = epoch
        self._held = True
        return epoch

    def renew(self) -> bool:
        """Extend the held lease's expiry.  True = still the leader;
        False = definitively DEPOSED (the record belongs to a higher
        epoch / different holder, or was released) — stop serving.  An
        INCONCLUSIVE renew — the KV unreachable or the CAS contended
        past the jittered retry budget, with no rival record ever
        observed — raises TimeoutError instead: the holder may well
        still own a live lease, so deposing would turn a KV blip far
        shorter than the TTL into a full serving outage.  Callers keep
        serving through it (fencing is the safety net) and retry."""
        if self._faults is not None:
            self._faults.fire("lease.renew", detail=self.holder)
        if not self._held:
            return False
        for attempt in range(self.renew_retries + 1):
            if attempt:
                # seeded jittered exponential backoff: N frontends whose
                # KV blipped at once must not retry in lockstep, while
                # chaos replays stay reproducible
                back = self.retry_backoff_s * (2.0 ** (attempt - 1))
                self._sleep(back * (0.5 + self._rng.random()))
            raw = self._kv.get(self.key)
            rec = self._parse(raw)
            if rec is not None:
                try:
                    rec_epoch = int(rec.get("epoch", -1))
                except (TypeError, ValueError):
                    rec_epoch = -1     # damaged record ≠ ours: deposed,
                if (rec_epoch != self.epoch    # never an untyped raise
                        or rec.get("holder") != self.holder
                        or rec.get("released")):
                    self._held = False
                    return False   # deposed: the record is not ours
            if rec is None:
                continue       # KV blip (or deleted record): retry
            if self._write(raw, {"epoch": self.epoch, "holder": self.holder,
                                 "expires": self._clock() + self.ttl_s,
                                 "released": False}):
                return True
            # CAS raced — re-read; if a standby took over we exit above
        # _held stays True: nothing proved deposition, and the next
        # renew (or a worker fence) will settle it definitively
        raise TimeoutError(
            f"lease renew inconclusive for {self.holder!r}: KV "
            f"unreachable or CAS contended through "
            f"{self.renew_retries + 1} attempts — still holding, retry")

    def release(self) -> bool:
        """Expire the held lease EARLY (graceful handoff): the record
        keeps its epoch — monotonicity is the fencing contract — but is
        marked released with a past expiry, so a standby's next poll
        acquires ``epoch+1`` immediately."""
        if not self._held:
            return False
        self._held = False
        raw = self._kv.get(self.key)
        rec = self._parse(raw)
        try:
            rec_epoch = int(rec.get("epoch", -1)) if rec else -1
        except (TypeError, ValueError):
            rec_epoch = -1     # damaged record is not ours
        if rec is None or rec_epoch != self.epoch \
                or rec.get("holder") != self.holder:
            return False       # already superseded; nothing to release
        return self._write(raw, {"epoch": self.epoch, "holder": self.holder,
                                 "expires": self._clock(),
                                 "released": True})


class StandbyFrontend:
    """Hot-standby supervisor: watches the frontend lease and takes over
    when it expires (crash, zombie) or is released (graceful handoff).

    >>> standby = StandbyFrontend(
    ...     FrontendLease(ep, holder="frontend-b"), journal_path,
    ...     lambda: [RemoteReplica(n) for n in connect_workers(ep)])
    >>> fe = standby.poll()          # None while the active holder lives
    >>> fe = standby.wait_for_takeover(timeout_s=60)   # blocking variant

    On takeover: acquire the lease at ``epoch+1`` (atomic — a racing
    standby loses and keeps polling), build replicas via
    ``replica_factory()`` (fresh engines, or ``fleet.connect_workers``
    for workers that outlived the dead frontend), and
    ``ServingFrontend.recover`` the journal — which reaps orphans WITH
    THE NEW EPOCH, so the first recovery RPC already fences every older
    incarnation out of the workers.  The returned frontend owns the
    lease (renewed inside its ``step()``), counts the takeover in
    ``standby_takeovers_total`` (+ ``failovers_total`` when the old
    lease EXPIRED rather than being released), and exports its epoch as
    the ``lease_epoch`` gauge."""

    def __init__(self, lease: FrontendLease, journal, replica_factory,
                 *, frontend_kwargs: Optional[Dict] = None):
        self.lease = lease
        self.journal = journal
        self.replica_factory = replica_factory
        self.frontend_kwargs = dict(frontend_kwargs or {})
        self.frontend = None

    def poll(self):
        """One watch iteration: None while the active lease is live (or
        a racing standby wins the acquire); the recovered ACTIVE
        frontend once this standby takes over.  Idempotent after
        takeover (returns the same frontend)."""
        if self.frontend is not None:
            return self.frontend
        rec = self.lease.read()
        if self.lease.live(rec):
            return None
        # expiry = the holder crashed or zombied through its TTL; a
        # released record is the graceful-handoff path, and an ABSENT
        # record is first-ever bootstrap — neither is a failover (the
        # counter must equal actual crash/zombie takeovers for the
        # counter-based chaos gates and ops alerts keyed on it)
        was_failover = rec is not None and not rec.get("released")
        # the journal's recorded epoch floors the acquisition: a LOST
        # lease record (KV restart, operator deletion) must not restart
        # the monotone epoch counter at 1 (see FrontendLease.acquire)
        try:
            from .journal import recorded_epoch

            floor = recorded_epoch(self.journal)
        except Exception:  # noqa: BLE001 — corrupt journal: recover()
            floor = None   # below raises the loud, typed error for it
        epoch = self.lease.acquire(min_epoch=floor)
        if epoch is None:
            return None        # raced with another standby; keep watching
        from .control_plane import ServingFrontend

        try:
            fe = ServingFrontend.recover(
                self.journal, self.replica_factory(),
                epoch=epoch, lease=self.lease, **self.frontend_kwargs)
        except BaseException:
            # a failed takeover (replica_factory / recovery fault) must
            # not leave the fresh lease HELD: every standby — including
            # this one — would see a live lease and wait out a full TTL
            # per attempt.  Release keeps the epoch counter (the burned
            # epoch is the price of monotonicity) and lets the next
            # poll retry immediately.
            try:
                self.lease.release()
            # graft-lint: disable=typed-termination — best-effort release
            # on the failed-takeover path; the recover() fault below is
            # what propagates, and TTL expiry re-opens the lease anyway
            except Exception:  # noqa: BLE001 — TTL expiry still unblocks
                pass
            raise
        fe.metrics.inc("standby_takeovers_total")
        if was_failover:
            fe.metrics.inc("failovers_total")
        if getattr(fe, "tracer", None) is not None:
            fe.tracer.process_event("takeover", epoch=epoch,
                                    failover=was_failover)
        self.frontend = fe
        return fe

    def wait_for_takeover(self, timeout_s: float = 60.0,
                          poll_interval_s: float = 0.1):
        """Poll until takeover; raises TimeoutError past ``timeout_s``.
        (The wall clock here only BOUNDS the wait — correctness gates
        stay counter-based, per the chaos contract.)"""
        # graft-lint: disable=determinism — real-time bound on a real
        # wait; correctness gates stay counter-based (docstring above)
        deadline = time.monotonic() + timeout_s
        # graft-lint: disable=determinism — same real-time bound
        while time.monotonic() < deadline:
            fe = self.poll()
            if fe is not None:
                return fe
            time.sleep(poll_interval_s)
        raise TimeoutError(
            f"standby {self.lease.holder!r}: no takeover within "
            f"{timeout_s}s (lease {self.lease.read()})")
