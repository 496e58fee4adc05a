"""Live serving metrics for the control plane (reference analog: the
fleet elastic manager's health/metrics reporting — here the observable
surface of `inference/control_plane.py`).

Pure Python, copied from ``paddle_tpu/inference/metrics.py`` so that
the port never imports the JAX package; names and metric names are the
reference's, so one test drives both.

`ServingMetrics` is a small host-side registry sampled inside the
frontend's step loop: monotonically increasing counters (admissions,
sheds, preemptions, deaths, tokens), point-in-time gauges (queue depth,
block-pool utilization), and latency sample sets (TTFT, per-token
latency, end-to-end) with percentile summaries.  Two exports:

* ``snapshot()``      — a plain dict for programmatic health checks;
* ``prometheus_text()`` — Prometheus text exposition (counter/gauge
  lines + ``summary`` quantiles) for scraping.

Fleet aggregation (the cross-host serving layer in
``inference/fleet.py``): each remote worker keeps its own registry and
ships ``snapshot(include_samples=True)`` dicts over RPC;
``ServingMetrics.merge(snapshots)`` folds them into one snapshot
(counters summed, peaks maxed, pool utilization recomputed from merged
totals, percentiles recomputed from raw samples when present), and
``prometheus_text_fleet({name: snapshot})`` renders one scrape page
with a ``replica`` label per series.

The clock is injectable so deadline/latency behavior is deterministic
under test; nothing here touches the device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple, Union)

__all__ = ["ServingMetrics", "fold_prefix_counters", "fold_counter_deltas"]

_PREFIX = "paddle_tpu_serving_"

COUNTERS = (
    "admitted_total", "rejected_overloaded_total", "shed_deadline_total",
    "preempted_total", "resumed_total", "cancelled_total", "completed_total",
    "failed_total", "replica_deaths_total", "requeued_on_failover_total",
    "tokens_emitted_total", "engine_steps_total",
    "prefix_hit_blocks_total", "prefix_miss_blocks_total",
    "prefix_evictions_total",
    # fault containment: retry budgets / poison quarantine,
    # brownout degradation, spawn breaker — counters are plain sums, so
    # merge() folds them fleet-wide with no special cases
    "requests_retried_total", "requests_quarantined_total",
    "shed_brownout_total", "brownout_capped_total",
    "brownout_transitions_total",
    "spawn_failures_total", "breaker_open_total",
    # megastep decode: compiled K-step scan launches and the
    # tokens they emitted (megastep_tokens/megasteps ~ the realized K),
    # plus streaming-callback faults the step loop absorbed
    "megasteps_total", "megastep_tokens_total",
    # mixed-phase megastep: scan launches that packed prefill
    # chunks alongside decode rows, and every prompt chunk fed (both the
    # in-scan chunks and single-step prefill feeds — the ratio
    # prefill_chunks/megastep_mixed shows how much prefill rides the scan)
    "megastep_mixed_total", "prefill_chunks_total",
    "stream_callback_errors_total",
    # durable control plane: write-ahead request journal,
    # crash recovery, idempotent submission
    "journal_records_total", "journal_bytes_total",
    "journal_compactions_total", "journal_errors_total",
    "recoveries_total", "recovered_requests_total",
    "orphans_reaped_total", "idempotent_hits_total",
    # HA control plane: lease-based leadership + fencing
    # epochs.  fenced_rpcs_total counts in the registry of whoever did
    # the fencing (worker-side for remote replicas, the deposed
    # frontend's own registry when IT observes StaleEpoch) — each fence
    # event lands in exactly one scraped registry
    "fenced_rpcs_total", "failovers_total", "handoffs_total",
    "standby_takeovers_total",
    # disaggregated prefill/decode: prefill passes run on
    # prefill-role replicas, requests parked behind an identical
    # in-flight prefill, transfer faults, and every fabric fault that
    # degraded to recomputing the prefix locally (the recompute counter
    # is the fabric's health signal: correctness never depends on it
    # staying zero, throughput does).  Worker-side:
    # fabric_blocks_imported_total counts blocks landed via
    # _w_import_blocks in the importing worker's own registry
    "fabric_prefill_passes_total", "fabric_dedup_waits_total",
    "fabric_pull_failures_total", "fabric_recomputes_total",
    "fabric_blocks_imported_total",
    # binary KV data plane: which rung of KVFabric.pull's
    # transport ladder each transfer landed on — wire = one payload hop
    # straight between workers, relay = the two-hop control-channel
    # fallback.  Frontend-side per pull; _w_pull_blocks also counts
    # fabric_wire_pulls_total in the pulling worker's own registry
    "fabric_wire_pulls_total", "fabric_relay_pulls_total",
    # multi-tenant elastic platform: rolling weight swaps
    # (attempted/failed), fabric pull-target re-plans after a decode
    # replica death, warm-pool lifecycle (attach/refill/attach-failure),
    # and the tenant control plane (budget rejections, model-affine
    # routing hits, dispatches parked behind a pending model swap).
    # Per-tenant served/outstanding series use dynamic names
    # ("tenant_<name>_served_tokens_total") through the open registry.
    "weight_swaps_total", "weight_swap_failures_total",
    "fabric_replans_total",
    "pool_attaches_total", "pool_refills_total",
    "pool_attach_failures_total",
    "tenant_rejected_budget_total", "tenant_routing_hits_total",
    "tenant_swap_waits_total",
    # speculative decoding: draft tokens committed by the
    # verify (beyond the one token a forward always emits), draft tokens
    # proposed by the host n-gram drafter, and rows scored by verify
    # launches (a per-token forward-equivalent: verify_forwards ÷
    # (accepted + verify_forwards) is the forwards-per-committed-token
    # ratio the bench ladder gates < 1.0)
    "accepted_tokens_total", "spec_draft_tokens_total",
    "spec_verify_forwards_total",
)
GAUGES = (
    "queue_depth", "queue_depth_peak", "running_requests", "replicas_alive",
    "blocks_capacity", "blocks_free", "block_pool_utilization",
    "block_pool_utilization_peak", "prefix_cache_hit_rate",
    # 0/1/2 brownout level and 0 / 0.5 / 1 breaker state (closed/half/open)
    "degraded_mode", "respawn_breaker_open",
    # 1 when a journal-armed frontend hit a journal I/O fault and fell
    # back to NON-DURABLE serving (the loud flag ops alert on: requests
    # keep flowing but a crash now loses them)
    "journal_degraded",
    # the frontend's fencing epoch (monotone across incarnations; a
    # fleet-wide scrape shows every registry agreeing on the current one)
    "lease_epoch",
    # per-phase step-time attribution: cumulative host seconds
    # the engine spent scheduling/admitting, executing compiled programs,
    # and harvesting emitted tokens — gauges mirroring the engine's own
    # monotone accumulators (merge() sums them fleet-wide)
    "step_phase_schedule_seconds", "step_phase_execute_seconds",
    "step_phase_harvest_seconds",
    # warm-worker pool: pre-booted workers ready to attach
    # (ready + refills in flight) — the autoscaler's near-zero-latency
    # scale-up headroom
    "warm_pool_depth",
)
SAMPLES = ("ttft_seconds", "token_latency_seconds", "e2e_latency_seconds")

# engine-level prefix-cache counters, in the order fold_prefix_counters
# expects its (hit_blocks, miss_blocks, evictions) tuples
PREFIX_COUNTERS = ("prefix_hit_blocks_total", "prefix_miss_blocks_total",
                   "prefix_evictions_total")
# engine-level megastep counters, in the order their (megasteps, tokens,
# mixed, prefill_chunks) fold tuples are built (control_plane gauge
# sampler / fleet _w_step) — extend at the END only: the tuple order IS
# the wire order of every mirrored ``mega_seen`` fold tuple
MEGASTEP_COUNTERS = ("megasteps_total", "megastep_tokens_total",
                     "megastep_mixed_total", "prefill_chunks_total")
# engine-level speculative-decode counters, in the order
# their (accepted, drafted, verify_forwards) fold tuples are built —
# same end-extend-only rule as MEGASTEP_COUNTERS: the tuple order IS
# the wire order of every mirrored ``spec_seen`` fold tuple
SPEC_COUNTERS = ("accepted_tokens_total", "spec_draft_tokens_total",
                 "spec_verify_forwards_total")


def fold_counter_deltas(metrics: "ServingMetrics", names, cur, seen):
    """Fold one engine's monotone counter tuple into a registry as
    deltas; returns ``cur`` (the caller's next ``seen``).  Delta-folding
    keeps registry counters monotone across replica death and
    ``reset()`` windows — the same contract for every engine-level
    counter the control plane or a fleet worker mirrors."""
    for name, c, s in zip(names, cur, seen):
        if c > s:
            metrics.inc(name, c - s)
    return cur


def fold_prefix_counters(metrics: "ServingMetrics", cur, seen):
    """Fold one engine's monotone prefix counters into a registry as
    deltas and refresh the hit-rate gauge; returns ``cur`` (the caller's
    next ``seen``).  Shared by the frontend's gauge sampler (per replica)
    and the fleet worker's step handler."""
    cur = fold_counter_deltas(metrics, PREFIX_COUNTERS, cur, seen)
    hit = metrics.counter("prefix_hit_blocks_total")
    miss = metrics.counter("prefix_miss_blocks_total")
    metrics.set_gauge("prefix_cache_hit_rate",
                      hit / (hit + miss) if (hit + miss) else 0.0)
    return cur


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class ServingMetrics:
    """Counter/gauge/latency-sample registry for one ServingFrontend."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 max_samples: int = 65536):
        self._clock = clock
        self._max_samples = int(max_samples)
        # one registry is written from several threads: worker-side
        # registries by concurrent RPC handler threads (distributed/rpc
        # serves from a ThreadingHTTPServer — _w_health snapshots while
        # _w_step incs), fleet frontend registries by async spawn
        # threads' failure bookkeeping.  dict get-add-store is not
        # atomic, so every access below locks; re-entrant because
        # snapshot() composes the locked summary/rate views
        self._lock = threading.RLock()
        self.reset()

    def reset(self):
        """Zero everything (e.g. after a warmup/compile phase)."""
        with self._lock:
            self._t0 = self._clock()
            self._counters: Dict[str, int] = {k: 0 for k in COUNTERS}    # guarded-by: self._lock
            self._gauges: Dict[str, float] = {k: 0.0 for k in GAUGES}    # guarded-by: self._lock
            self._samples: Dict[str, List[float]] = {k: [] for k in SAMPLES}  # guarded-by: self._lock
            self._sample_counts: Dict[str, int] = {k: 0 for k in SAMPLES}     # guarded-by: self._lock
            self._sample_sums: Dict[str, float] = {k: 0.0 for k in SAMPLES}   # guarded-by: self._lock
            # trace-linked exemplars: the most recent
            # (trace_id, value) pairs per latency series, so a p95
            # outlier on the scrape page is one trace lookup away —
            # bounded per series, zero-cost when no trace_id is passed
            self._exemplars: Dict[str, deque] = {}                             # guarded-by: self._lock
            self._first_emit_t: Optional[float] = None
            self._last_emit_t: Optional[float] = None
            self._tokens_at_first_emit = 0

    # ------------------------------------------------------------- record
    def now(self) -> float:
        return self._clock()

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def set_gauge_peak(self, name: str, value: float):
        """Set ``name`` and keep a high-water mark in ``name + '_peak'``
        (a final snapshot of a drained system would otherwise read 0 for
        every pressure gauge)."""
        with self._lock:
            self._gauges[name] = float(value)
            peak = name + "_peak"
            self._gauges[peak] = max(self._gauges.get(peak, 0.0),
                                     float(value))

    def observe(self, name: str, value: float,
                trace_id: Optional[str] = None):
        with self._lock:
            buf = self._samples.setdefault(name, [])
            cnt = self._sample_counts.get(name, 0)
            if len(buf) < self._max_samples:
                buf.append(float(value))
            else:
                buf[cnt % self._max_samples] = float(value)
            self._sample_counts[name] = cnt + 1
            self._sample_sums[name] = (self._sample_sums.get(name, 0.0)
                                       + float(value))
            if trace_id is not None:
                ex = self._exemplars.get(name)
                if ex is None:
                    ex = self._exemplars[name] = deque(maxlen=8)
                ex.append((trace_id, float(value)))

    def note_tokens(self, n: int, t: Optional[float] = None):
        """Record ``n`` tokens emitted at time ``t`` (defaults to now)."""
        if n <= 0:
            return
        t = self._clock() if t is None else t
        with self._lock:
            self.inc("tokens_emitted_total", n)
            if self._first_emit_t is None:
                self._first_emit_t = t
                self._tokens_at_first_emit = n
            self._last_emit_t = t

    # -------------------------------------------------------------- views
    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str) -> float:
        with self._lock:
            return self._gauges.get(name, 0.0)

    def exemplars(self, name: str) -> List[Tuple[str, float]]:
        """Most recent (trace_id, value) pairs observed for ``name`` —
        the lookup that turns a latency outlier into a span tree."""
        with self._lock:
            return list(self._exemplars.get(name, ()))

    def tokens_per_sec(self) -> float:
        """Steady-state emission rate: tokens after the first emission
        event over the first→last emission window (excludes compile/queue
        lead-in); falls back to total/uptime for single-emission runs."""
        with self._lock:
            tokens = self.counter("tokens_emitted_total")
            if tokens <= 0:
                return 0.0
            if (self._first_emit_t is not None
                    and self._last_emit_t is not None
                    and self._last_emit_t > self._first_emit_t
                    and tokens > self._tokens_at_first_emit):
                return ((tokens - self._tokens_at_first_emit)
                        / (self._last_emit_t - self._first_emit_t))
            return tokens / max(self._clock() - self._t0, 1e-9)

    def summary(self, name: str) -> Dict[str, float]:
        """Quantile summary of ONE sample series (count/sum/mean/p50/p95/
        max) — what hot-loop consumers like the autoscaler's TTFT check
        should call instead of a full ``snapshot()`` (which sorts every
        series)."""
        return self._summary(name)

    def _summary(self, name: str) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._samples.get(name, []))
            cnt = self._sample_counts.get(name, 0)
            total = self._sample_sums.get(name, 0.0)
        return {
            "count": cnt,
            "sum": total,
            "mean": (total / cnt) if cnt else 0.0,
            "p50": _percentile(vals, 0.50),
            "p95": _percentile(vals, 0.95),
            "max": vals[-1] if vals else 0.0,
        }

    def snapshot(self, include_samples: bool = False) -> Dict:
        """Programmatic point-in-time view of the whole registry.

        ``include_samples=True`` additionally carries the raw latency
        sample buffers (bounded by ``max_samples``) so a downstream
        ``merge`` can recompute exact percentiles across registries —
        this is what fleet workers ship over RPC."""
        with self._lock:
            snap = {
                "uptime_s": self._clock() - self._t0,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "latency": {k: self._summary(k) for k in self._samples},
                "tokens_per_sec": self.tokens_per_sec(),
            }
            if include_samples:
                snap["samples"] = {k: list(v)
                                   for k, v in self._samples.items()}
        return snap

    # ------------------------------------------------------- fleet merging
    @staticmethod
    def merge(snapshots: Union[Mapping[str, Dict], Iterable[Dict]]) -> Dict:
        """Fold per-replica ``snapshot()`` dicts into one fleet snapshot.

        Counters and token rates are summed (parallel replicas add),
        additive gauges (queue depth, running requests, block totals) are
        summed, ``*_peak`` gauges are maxed, and the block-pool
        utilization pair is recomputed from the merged free/total so it
        stays a true fleet-wide ratio.  Latency percentiles are exact
        when the snapshots carry raw samples (``include_samples=True``);
        otherwise they fall back to a count-weighted average of the
        per-replica quantiles (labelled via ``percentiles_exact``)."""
        if isinstance(snapshots, Mapping):
            snaps = list(snapshots.values())
        else:
            snaps = list(snapshots)
        if not snaps:
            return {"uptime_s": 0.0, "counters": {}, "gauges": {},
                    "latency": {}, "tokens_per_sec": 0.0,
                    "percentiles_exact": True, "num_replicas": 0}
        counters: Dict[str, int] = {}
        for s in snaps:
            for k, v in (s.get("counters") or {}).items():
                counters[k] = counters.get(k, 0) + v
        gauges: Dict[str, float] = {}
        # level/state gauges are ordinal, not additive: two replicas at
        # brownout level 1 are NOT a fleet at level 2
        _maxed = ("degraded_mode", "respawn_breaker_open",
                  "journal_degraded", "lease_epoch")
        for s in snaps:
            for k, v in (s.get("gauges") or {}).items():
                if k.endswith("_peak") or k in _maxed:
                    gauges[k] = max(gauges.get(k, 0.0), float(v))
                else:
                    gauges[k] = gauges.get(k, 0.0) + float(v)
        total = gauges.get("blocks_capacity", 0.0)
        free = gauges.get("blocks_free", 0.0)
        if "block_pool_utilization" in gauges:
            gauges["block_pool_utilization"] = \
                (1.0 - free / total) if total else 0.0
        # ratio gauges don't add: recompute the fleet-wide prefix hit rate
        # from the merged counters, same as pool utilization above
        if "prefix_cache_hit_rate" in gauges:
            hit = counters.get("prefix_hit_blocks_total", 0)
            miss = counters.get("prefix_miss_blocks_total", 0)
            gauges["prefix_cache_hit_rate"] = \
                hit / (hit + miss) if (hit + miss) else 0.0
        have_samples = all("samples" in s for s in snaps)
        names: List[str] = []
        for s in snaps:
            for k in (s.get("latency") or {}):
                if k not in names:
                    names.append(k)
        latency: Dict[str, Dict[str, float]] = {}
        for name in names:
            subs = [s["latency"][name] for s in snaps
                    if name in (s.get("latency") or {})]
            cnt = sum(int(x.get("count", 0)) for x in subs)
            tot = sum(float(x.get("sum", 0.0)) for x in subs)
            out = {"count": cnt, "sum": tot,
                   "mean": (tot / cnt) if cnt else 0.0,
                   "max": max((float(x.get("max", 0.0)) for x in subs),
                              default=0.0)}
            if have_samples:
                vals = sorted(v for s in snaps
                              for v in (s["samples"].get(name) or []))
                out["p50"] = _percentile(vals, 0.50)
                out["p95"] = _percentile(vals, 0.95)
            else:
                for q in ("p50", "p95"):
                    out[q] = (sum(float(x.get(q, 0.0)) * int(x.get("count", 0))
                                  for x in subs) / cnt) if cnt else 0.0
            latency[name] = out
        return {
            "uptime_s": max(float(s.get("uptime_s", 0.0)) for s in snaps),
            "counters": counters,
            "gauges": gauges,
            "latency": latency,
            "tokens_per_sec": sum(float(s.get("tokens_per_sec", 0.0))
                                  for s in snaps),
            "percentiles_exact": have_samples,
            "num_replicas": len(snaps),
        }

    # ----------------------------------------------------------- rendering
    @staticmethod
    def _render_families(snapshot: Dict,
                         labels: Optional[Dict[str, str]] = None):
        """-> [(family_name, prom_type, [sample lines])] for one snapshot.
        The grouping unit matters: the exposition format requires ALL
        samples of a metric family to sit together under one # TYPE
        header, so multi-snapshot renderers merge at family granularity.
        """
        base = [f'{k}="{v}"' for k, v in (labels or {}).items()]

        def series(name: str, *extra: str) -> str:
            lab = ",".join(base + list(extra))
            return f"{name}{{{lab}}}" if lab else name

        fams = []
        for name in sorted(snapshot.get("counters") or {}):
            full = _PREFIX + name
            fams.append((full, "counter",
                         [f"{series(full)} {snapshot['counters'][name]}"]))
        gauges = dict(snapshot.get("gauges") or {})
        gauges["tokens_per_sec"] = snapshot.get("tokens_per_sec", 0.0)
        for name in sorted(gauges):
            full = _PREFIX + name
            fams.append((full, "gauge",
                         [f"{series(full)} {gauges[name]:.6g}"]))
        for name in sorted(snapshot.get("latency") or {}):
            full = _PREFIX + name
            s = snapshot["latency"][name]
            q50, q95 = 'quantile="0.5"', 'quantile="0.95"'
            fams.append((full, "summary", [
                f"{series(full, q50)} {s['p50']:.6g}",
                f"{series(full, q95)} {s['p95']:.6g}",
                f"{series(full + '_count')} {s['count']}",
                f"{series(full + '_sum')} {s['sum']:.6g}"]))
        return fams

    @staticmethod
    def render_prometheus(snapshot: Dict,
                          labels: Optional[Dict[str, str]] = None) -> List[str]:
        """Render one ``snapshot()`` dict as Prometheus text-exposition
        lines; ``labels`` (e.g. ``{"replica": "worker0"}``) are attached
        to every series.  Returns the lines (callers join pages)."""
        lines: List[str] = []
        for fam, ptype, samples in ServingMetrics._render_families(snapshot,
                                                                   labels):
            lines.append(f"# TYPE {fam} {ptype}")
            lines.extend(samples)
        return lines

    @staticmethod
    def prometheus_text_fleet(snapshots: Mapping[str, Dict]) -> str:
        """One scrape page for a whole fleet: every replica's snapshot with
        a ``replica="<name>"`` label, grouped BY METRIC FAMILY (all of a
        family's labelled series under its single # TYPE header — the
        text-exposition format rejects interleaved families)."""
        order: List[str] = []              # family order of first appearance
        types: Dict[str, str] = {}
        by_family: Dict[str, List[str]] = {}
        for rname in sorted(snapshots):
            for fam, ptype, samples in ServingMetrics._render_families(
                    snapshots[rname], labels={"replica": rname}):
                if fam not in by_family:
                    order.append(fam)
                    types[fam] = ptype
                    by_family[fam] = []
                by_family[fam].extend(samples)
        lines: List[str] = []
        for fam in order:
            lines.append(f"# TYPE {fam} {types[fam]}")
            lines.extend(by_family[fam])
        return "\n".join(lines) + "\n"

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape page)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._counters):
                full = _PREFIX + name
                lines.append(f"# TYPE {full} counter")
                lines.append(f"{full} {self._counters[name]}")
            for name in sorted(self._gauges):
                full = _PREFIX + name
                lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full} {self._gauges[name]:.6g}")
            full = _PREFIX + "tokens_per_sec"
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {self.tokens_per_sec():.6g}")
            # the sample loop stays INSIDE the lock (re-entrant through
            # _summary): releasing between sections would let a
            # concurrent reset() produce one scrape page mixing
            # pre-reset counters with post-reset latency summaries
            for name in sorted(self._samples):
                full = _PREFIX + name
                s = self._summary(name)
                lines.append(f"# TYPE {full} summary")
                lines.append(f'{full}{{quantile="0.5"}} {s["p50"]:.6g}')
                lines.append(f'{full}{{quantile="0.95"}} {s["p95"]:.6g}')
                lines.append(f"{full}_count {s['count']}")
                lines.append(f"{full}_sum {s['sum']:.6g}")
                # trace-linked exemplars as comment lines (the 0.0.4 text
                # format has no exemplar syntax; OpenMetrics-style braces
                # keep them greppable without breaking strict parsers)
                for tid, v in self._exemplars.get(name, ()):
                    lines.append(
                        f'# EXEMPLAR {full} {{trace_id="{tid}"}} {v:.6g}')
        return "\n".join(lines) + "\n"
