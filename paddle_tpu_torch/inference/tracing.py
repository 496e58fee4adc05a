"""Request-lifecycle tracing: fleet-wide span trees, a
bounded per-process flight recorder, and trace-linked exemplars.

Copied from ``paddle_tpu/inference/tracing.py`` (the port never imports
the JAX package); the port's engine emits the same events
(``ServingEngine.pop_trace_events``), so the digests agree.

The serving stack's aggregate counters (``metrics.py``) answer "how many
requests were preempted"; they cannot answer "what did THIS p95-outlier
request experience across three processes".  This module adds the
Dapper-style per-request layer:

* **``TraceContext``** — (trace_id, span, parent, rid), minted at
  admission and propagated everywhere the request goes.  The trace id is
  a deterministic digest of ``namespace:rid`` — no wall clock, no
  unseeded randomness — so a same-seed chaos replay mints the SAME ids
  and event sequences compare byte-identical, and a journal-recovered
  request keeps its trace (the id rides the admit record).  Attempt
  spans (``attempt-1``, ``attempt-2`` after a failover/preemption
  re-dispatch) are children of the root ``request`` span; worker-side
  events land on the attempt span they were handed over RPC (stamped
  like ``epoch=``), distinguished by their ``proc`` field — one
  fleet-wide tree per request.
* **``FlightRecorder``** — bounded ring (``deque(maxlen)``) of event
  dicts with an injectable ``clock`` (``clock=time.monotonic`` as a
  DEFAULT parameter is the determinism-lint-sanctioned injection
  point).  Overflow drops the OLDEST events and counts them
  (``dropped``) — a flight recorder keeps the recent past, it never
  grows without bound or blocks the data plane.
* **``Tracer``** — frontend-side assembly: mints contexts, records
  span/process events into its recorder, absorbs worker-shipped events
  (the ``_w_step`` piggyback / ``_w_pop_traces`` RPC), keeps a bounded
  per-trace index for tree assembly, and auto-captures the offending
  tree for slow requests and non-COMPLETED typed terminals.
* **``assemble_trees`` / ``tree_complete``** — the chaos-soak contract:
  every typed terminal owns a tree whose root ``request`` span has
  exactly one ``terminal`` event and whose every non-root span hangs
  off a span that exists (orphan-free).

Event record shape (plain dicts end to end — JSON-able for the journal,
RPC piggyback, and ``tools/trace_dump.py``)::

    {"trace": "9f2c...", "span": "attempt-1", "parent": "request",
     "event": "dispatch", "rid": 3, "t": 12.5, "proc": "frontend",
     "seq": 17, "attrs": {"replica": 0}}

Process events (lease renew/depose, brownout level moves, breaker
transitions, fault-injection fires, takeover/handoff) carry
``trace=None`` — they are flight-recorder context, not request spans,
and are excluded from tree assembly.

Zero-cost when disabled: every hook in the serving stack is guarded by
``if tracer is None`` / ``if recorder is None`` (the same shape as the
``fault_injector`` zero-cost pattern), and nothing here runs inside a
compiled body — tracing is host-side only.

Pure stdlib, no torch, no package-relative imports: loadable standalone
(``tools/trace_dump.py --self-check`` imports this file by path in the
dependency-free CI lint job).
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["TraceContext", "FlightRecorder", "Tracer", "assemble_trees",
           "tree_complete", "event_signature", "events_digest"]


def _mint_trace_id(namespace: str, rid: int) -> str:
    # deterministic: same (namespace, rid) -> same id, so same-seed
    # replays produce identical event sequences and a recovered request
    # re-minted nowhere (the id rides the journal admit record)
    return hashlib.blake2b(f"{namespace}:{rid}".encode(),
                           digest_size=8).hexdigest()


class TraceContext:
    """One span's identity: ``trace_id`` names the request-wide tree,
    ``span`` this node, ``parent`` the span it hangs off (None for the
    root ``request`` span).  ``rid`` is the FRONTEND rid — engine-local
    rids differ per replica, so the wire form always carries the
    frontend's."""

    __slots__ = ("trace_id", "span", "parent", "rid")

    def __init__(self, trace_id: str, span: str = "request",
                 parent: Optional[str] = None, rid: Optional[int] = None):
        self.trace_id = trace_id
        self.span = span
        self.parent = parent
        self.rid = rid

    @classmethod
    def mint(cls, rid: int, namespace: str = "req") -> "TraceContext":
        return cls(_mint_trace_id(namespace, rid), "request", None, rid)

    def child(self, span: str) -> "TraceContext":
        return TraceContext(self.trace_id, span, self.span, self.rid)

    def to_wire(self) -> Dict[str, Any]:
        """JSON-able dict stamped onto cross-process calls (the tracing
        analog of the ``epoch=`` kwarg)."""
        return {"trace": self.trace_id, "span": self.span,
                "parent": self.parent, "rid": self.rid}

    @classmethod
    def from_wire(cls, wire: Dict[str, Any]) -> "TraceContext":
        return cls(wire["trace"], wire.get("span", "request"),
                   wire.get("parent"), wire.get("rid"))

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, span={self.span!r}, "
                f"parent={self.parent!r}, rid={self.rid!r})")


class FlightRecorder:
    """Bounded per-process event ring.  ``record`` never blocks and
    never grows past ``capacity`` (the oldest events fall off and are
    counted in ``dropped``); ``drain`` hands the buffered events to
    whoever ships them (the worker's ``_w_step`` piggyback /
    ``_w_pop_traces``, or the frontend ``Tracer``)."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 proc: str = "frontend"):
        self.capacity = int(capacity)
        self.proc = proc
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self.dropped = 0

    def record(self, trace: Optional[str], span: Optional[str],
               parent: Optional[str], event: str,
               rid: Optional[int] = None, **attrs) -> Dict[str, Any]:
        ev: Dict[str, Any] = {
            "trace": trace, "span": span, "parent": parent,
            "event": event, "rid": rid, "t": self._clock(),
            "proc": self.proc, "seq": self._seq,
        }
        if attrs:
            ev["attrs"] = attrs
        self._seq += 1
        if len(self._ring) == self.capacity:
            self.dropped += 1
        self._ring.append(ev)
        return ev

    def drain(self) -> List[Dict[str, Any]]:
        out = list(self._ring)
        self._ring.clear()
        return out

    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)


class Tracer:
    """Frontend-side trace mint + event store + tree assembly.

    The flight recorder is the bounded "recent past" view; the per-trace
    index (``events_for``/``all_events``) is what tree assembly and the
    chaos-soak completeness gates read, bounded by ``max_traces``
    (oldest trace evicted whole).  ``slow_threshold_s`` and non-OK
    terminals drive ``captures`` — the offending tree is copied out
    before its trace can be evicted, bounded by ``capture_limit``."""

    def __init__(self, capacity: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 proc: str = "frontend", namespace: str = "req",
                 max_traces: int = 1024,
                 slow_threshold_s: Optional[float] = None,
                 capture_limit: int = 16):
        self.recorder = FlightRecorder(capacity, clock, proc)
        self.namespace = namespace
        self.max_traces = int(max_traces)
        self.slow_threshold_s = slow_threshold_s
        self.capture_limit = int(capture_limit)
        self._by_trace: "OrderedDict[str, List[Dict]]" = OrderedDict()
        self.captures: "OrderedDict[str, Dict]" = OrderedDict()

    # ------------------------------------------------------------- minting
    def begin(self, rid: int) -> TraceContext:
        return TraceContext.mint(rid, self.namespace)

    def adopt(self, trace_id: str, rid: int) -> TraceContext:
        """Root context for a trace id read back from a journal admit
        record — the recovered request KEEPS its trace."""
        return TraceContext(trace_id, "request", None, rid)

    # ----------------------------------------------------------- recording
    def event(self, ctx: Optional[TraceContext], name: str,
              **attrs) -> Optional[Dict]:
        if ctx is None:
            return None
        ev = self.recorder.record(ctx.trace_id, ctx.span, ctx.parent,
                                  name, rid=ctx.rid, **attrs)
        self._index(ev)
        return ev

    def process_event(self, name: str, **attrs) -> Dict:
        """Trace-less flight-recorder context (lease/brownout/breaker/
        fault edges): visible in dumps, excluded from span trees."""
        return self.recorder.record(None, None, None, name, **attrs)

    def absorb(self, events: Iterable[Dict]) -> int:
        """Index worker-shipped span events (``_w_step`` piggyback /
        ``_w_pop_traces``) into the per-trace store."""
        n = 0
        for ev in events:
            if ev.get("trace") is not None:
                self._index(ev)
                n += 1
        return n

    def _index(self, ev: Dict):
        tid = ev["trace"]
        lst = self._by_trace.get(tid)
        if lst is None:
            lst = self._by_trace[tid] = []
            while len(self._by_trace) > self.max_traces:
                self._by_trace.popitem(last=False)
        lst.append(ev)

    # ------------------------------------------------------------ querying
    def events_for(self, trace_id: str) -> List[Dict]:
        return list(self._by_trace.get(trace_id, ()))

    def all_events(self) -> List[Dict]:
        out: List[Dict] = []
        for evs in self._by_trace.values():
            out.extend(evs)
        return out

    def tree_for(self, trace_id: str) -> Dict[str, List[Dict]]:
        trees = assemble_trees(self.events_for(trace_id))
        return trees.get(trace_id, {})

    # ------------------------------------------------------- auto-capture
    def capture(self, trace_id: str, reason: str):
        """Copy the trace's current tree into the bounded capture store
        (slow-request / typed-failure auto-capture)."""
        if trace_id in self.captures:
            self.captures[trace_id]["reason"] += f",{reason}"
            self.captures[trace_id]["events"] = self.events_for(trace_id)
            return
        self.captures[trace_id] = {"reason": reason,
                                   "events": self.events_for(trace_id)}
        while len(self.captures) > self.capture_limit:
            self.captures.popitem(last=False)

    def note_terminal(self, ctx: Optional[TraceContext], status: str,
                      e2e_s: Optional[float] = None,
                      ok_status: str = "completed"):
        """Auto-capture policy hook the control plane calls at each typed
        terminal: non-OK statuses and slow completions dump their tree."""
        if ctx is None:
            return
        if status != ok_status:
            self.capture(ctx.trace_id, status)
        elif (self.slow_threshold_s is not None and e2e_s is not None
                and e2e_s >= self.slow_threshold_s):
            self.capture(ctx.trace_id, "slow")


# ----------------------------------------------------------- tree assembly
def assemble_trees(events: Iterable[Dict]) -> Dict[str, Dict[str, List[Dict]]]:
    """{trace_id: {span: [events]}} — process events (trace=None) are
    skipped; within a span, events keep their given order."""
    trees: Dict[str, Dict[str, List[Dict]]] = {}
    for ev in events:
        tid = ev.get("trace")
        if tid is None:
            continue
        trees.setdefault(tid, {}).setdefault(ev.get("span") or "request",
                                             []).append(ev)
    return trees


def tree_complete(tree: Dict[str, List[Dict]]) -> Tuple[bool, str]:
    """The chaos-soak span-tree contract: the root ``request`` span
    exists and carries exactly one ``terminal`` event, and every
    non-root span is orphan-free (its ``parent`` names a span that has
    events in this tree — worker events whose dispatching frontend span
    was lost would fail here)."""
    root = tree.get("request")
    if not root:
        return False, "missing root 'request' span"
    n_term = sum(1 for e in root if e.get("event") == "terminal")
    if n_term != 1:
        return False, f"root span has {n_term} terminal events (want 1)"
    for span, evs in tree.items():
        if span == "request":
            continue
        parents = {e.get("parent") for e in evs} - {None}
        if not parents:
            return False, f"span {span!r} declares no parent"
        for p in parents:
            if p not in tree:
                return False, f"orphan span {span!r}: parent {p!r} absent"
    return True, ""


# ------------------------------------------------- deterministic signatures
def event_signature(ev: Dict) -> Tuple:
    """Wall-clock-free identity of one event: everything except ``t``
    and ``seq`` (the list ORDER already encodes the sequence; ``seq`` is
    per-process and shifts when unrelated process events interleave).
    Same-seed chaos replays must produce identical signature streams."""
    attrs = ev.get("attrs") or {}
    return (ev.get("trace"), ev.get("span"), ev.get("parent"),
            ev.get("event"), ev.get("rid"), ev.get("proc"),
            tuple(sorted((k, v) for k, v in attrs.items())))


def events_digest(events: Iterable[Dict]) -> str:
    """Replay-comparable digest over an event stream (timestamps and
    per-process seq excluded) — the chaos reports carry this so the
    same-seed full-report equality gates cover tracing too."""
    h = hashlib.blake2b(digest_size=8)
    for ev in events:
        h.update(repr(event_signature(ev)).encode())
    return h.hexdigest()
