"""Unified telemetry for both serving stacks (paper §6 methodology).

Clipper's evaluation is entirely measured behaviour — tail latency,
throughput, and SLO attainment under controlled arrival processes (Figs 4,
6, 9). This module is the single metrics layer both stacks report through:

* ``StreamingHistogram`` — fixed-layout log-bucketed histogram with
  deterministic percentile interpolation. Bounded memory, order-insensitive,
  and bit-reproducible: the same observations always produce the same
  P50/P95/P99, which turns tail latency into an *exact* test oracle.
* ``MetricsRegistry`` — counters, gauges, and histograms keyed by name plus
  an optional ``model`` label, with a canonical ``report()`` schema
  (``repro.metrics/v1``) shared by the discrete-event ``Clipper`` frontend
  and the continuous-batching ``LMServer``.
* ``VirtualClock`` — an advanceable clock satisfying the ``Clock`` protocol;
  with it, calibrated-simulation runs (DESIGN.md §8) produce byte-identical
  reports from a seed.

The registry is clock-agnostic: it never reads time itself. Callers pass
event times via ``mark()`` and durations via ``observe()``; throughput is
derived from the marked span.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Tuple

SCHEMA = "repro.metrics/v1"

# Canonical metric names — both stacks use exactly these.
QUERIES_SUBMITTED = "queries.submitted"
QUERIES_COMPLETED = "queries.completed"
QUERIES_SHED = "queries.shed"          # admission-rejected before enqueue
QUERIES_DEGRADED = "queries.degraded"  # served with a reduced ensemble
QUERIES_ROUTED = "queries.routed"      # enqueued to a model's replica set
REPLICAS_ADDED = "cluster.replicas_added"
REPLICAS_RETIRED = "cluster.replicas_retired"
SLO_VIOLATIONS = "slo.violations"
CACHE_HITS = "cache.hits"
CACHE_MISSES = "cache.misses"
STRAGGLER_PARTIAL = "straggler.partial_queries"
STRAGGLER_DROPPED = "straggler.dropped_models"
PIPELINE_STAGE_JOBS = "pipeline.stage_jobs"      # stage jobs launched
PIPELINE_STAGES_SKIPPED = "pipeline.stages_skipped"  # gated off (cascade)
PIPELINE_ESCALATIONS = "pipeline.escalations"    # gated stages that ran
PIPELINE_STAGES_SHED = "pipeline.stages_shed"    # stage jobs admission shed
PIPELINE_STAGES_DEGRADED = "pipeline.stages_degraded"  # stage jobs narrowed
PIPELINE_STAGES_FAILED = "pipeline.stages_failed"  # every model of a stage lost
# fault injection + recovery (DESIGN.md §14)
FAULTS_CRASHES = "faults.crashes"            # batches lost to crashed replicas
FAULTS_TRANSIENT = "faults.transient_errors"  # fail-fast batch errors
FAULTS_SLOW = "faults.slow_batches"          # batches under degraded latency
MODEL_FAILURES = "faults.failures"           # per-container failure total
FAULTS_DETECTED = "faults.detected"          # detector marked replica down
FAULTS_RECOVERED = "faults.recovered"        # probed replica rejoined routing
FAULTS_REQUEUED = "faults.requeued_queries"  # drained off a dead replica
FAULTS_RETRIES = "faults.retries"            # per-query re-dispatches
FAULTS_RETRY_EXHAUSTED = "faults.retry_exhausted"  # budget spent, gave up
FAULTS_HEDGES = "faults.hedges"              # hedged duplicate dispatches
FAULTS_HEDGE_WINS = "faults.hedge_wins"      # hedge finished before primary
BATCHES = "batches.dispatched"
LATENCY = "latency_s"          # end-to-end query latency histogram
SERVICE = "service_s"          # per-batch model service time histogram
BATCH_SIZE = "batch.size"      # dispatched batch-size histogram
QUEUE_DEPTH = "queue.depth"    # queue depth sampled at dispatch


class StreamingHistogram:
    """Log-bucketed streaming histogram with deterministic percentiles.

    Layout: ``buckets_per_decade`` geometric buckets per decade spanning
    [lo, hi); one underflow and one overflow bucket. An observation ``v``
    lands in bucket ``floor(log(v / lo) / log(g))`` for growth factor
    ``g = 10 ** (1 / buckets_per_decade)``. ``percentile(p)`` walks the
    cumulative counts to the bucket containing rank ``ceil(p/100 * n)`` and
    returns that bucket's geometric midpoint — a pure function of the
    observation multiset, exact for test oracles. True ``min``/``max``/
    ``sum`` are tracked exactly alongside.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 buckets_per_decade: int = 24):
        assert 0 < lo < hi and buckets_per_decade > 0
        self.lo = lo
        self.hi = hi
        self.bpd = buckets_per_decade
        self._log_g = math.log(10.0) / buckets_per_decade
        self.nbuckets = int(math.ceil(
            math.log(hi / lo) / self._log_g)) + 2      # + under/overflow
        self._counts = [0] * self.nbuckets
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self.nbuckets - 1
        return 1 + int(math.log(v / self.lo) / self._log_g)

    def _midpoint(self, b: int) -> float:
        if b <= 0:
            return self.lo
        if b >= self.nbuckets - 1:
            return self.hi
        return self.lo * math.exp((b - 0.5) * self._log_g)

    def observe(self, v: float) -> None:
        v = float(v)
        self._counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def percentile(self, p: float) -> float:
        """Geometric midpoint of the bucket holding rank ceil(p/100 * n)."""
        if self.count == 0:
            return float("nan")
        rank = max(1, math.ceil(p / 100.0 * self.count))
        cum = 0
        for b, c in enumerate(self._counts):
            cum += c
            if cum >= rank:
                return self._midpoint(b)
        return self._midpoint(self.nbuckets - 1)    # pragma: no cover

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def summary(self) -> Dict[str, Any]:
        # schema-stable: the key set never depends on whether anything was
        # observed (empty stats are null, valid JSON), so report consumers
        # can index unconditionally
        if self.count == 0:
            return {"count": 0, "sum": None, "mean": None, "min": None,
                    "max": None, "p50": None, "p95": None, "p99": None}
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class VirtualClock:
    """Advanceable clock for calibrated simulation: satisfies the ``Clock``
    protocol (zero-arg callable returning seconds) and is stepped explicitly
    by whatever owns the timeline."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        assert dt >= 0.0
        self.now += dt
        return self.now


_Key = Tuple[str, Optional[str]]           # (name, model label)


class MetricsRegistry:
    """Counters + gauges + histograms with per-model labels and the shared
    ``repro.metrics/v1`` report schema."""

    # histogram layouts by metric name: (lo, hi, buckets_per_decade)
    _LAYOUTS = {
        LATENCY: (1e-6, 1e4, 24),
        SERVICE: (1e-6, 1e4, 24),
        BATCH_SIZE: (1.0, 2.0 ** 13, 24),
        QUEUE_DEPTH: (1.0, 2.0 ** 13, 24),
    }

    def __init__(self, slo: Optional[float] = None):
        self.slo = slo
        self._counters: Dict[_Key, int] = {}
        self._hists: Dict[_Key, StreamingHistogram] = {}
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- recording ------------------------------------------------------
    def inc(self, name: str, n: int = 1, *, model: Optional[str] = None):
        key = (name, model)
        self._counters[key] = self._counters.get(key, 0) + n

    def observe(self, name: str, value: float, *,
                model: Optional[str] = None) -> None:
        key = (name, model)
        h = self._hists.get(key)
        if h is None:
            lo, hi, bpd = self._LAYOUTS.get(name, (1e-6, 1e4, 24))
            h = self._hists[key] = StreamingHistogram(lo, hi, bpd)
        h.observe(value)

    def inc_both(self, name: str, n: int = 1, *, model: str) -> None:
        """Increment the global series and the model-labeled series together
        — the paired emission every dispatch site needs."""
        self.inc(name, n)
        self.inc(name, n, model=model)

    def observe_both(self, name: str, value: float, *, model: str) -> None:
        """Observe into the global histogram and the model-labeled one."""
        self.observe(name, value)
        self.observe(name, value, model=model)

    def observe_latency(self, latency: float, *,
                        model: Optional[str] = None) -> None:
        """End-to-end latency + SLO attainment in one call.

        Deadline-finalized queries land *exactly* on the SLO (straggler
        mitigation, paper §5.2.2) — the epsilon keeps float noise in
        ``arrival + slo - arrival`` from miscounting them as violations.

        With a ``model`` label the observation lands in *both* the global
        and the labeled latency histogram (like the violation counters), so
        per-model tagging never starves the cross-stack global series."""
        self.observe(LATENCY, latency)
        if model is not None:
            self.observe(LATENCY, latency, model=model)
        if self.slo is not None and latency - self.slo > 1e-12:
            self.inc(SLO_VIOLATIONS)
            if model is not None:
                self.inc(SLO_VIOLATIONS, model=model)

    def mark(self, now: float) -> None:
        """Record an event time; the marked span defines the run duration."""
        if self._t_first is None:
            self._t_first = now
        self._t_last = now if self._t_last is None else max(self._t_last, now)

    # -- reading --------------------------------------------------------
    def counter(self, name: str, *, model: Optional[str] = None) -> int:
        return self._counters.get((name, model), 0)

    def hist(self, name: str, *,
             model: Optional[str] = None) -> Optional[StreamingHistogram]:
        return self._hists.get((name, model))

    def percentile(self, name: str, p: float, *,
                   model: Optional[str] = None) -> float:
        h = self.hist(name, model=model)
        return h.percentile(p) if h is not None else float("nan")

    @property
    def duration(self) -> float:
        if self._t_first is None or self._t_last is None:
            return 0.0
        return self._t_last - self._t_first

    def _models(self) -> List[str]:
        out = {m for (_, m) in self._counters if m is not None}
        out |= {m for (_, m) in self._hists if m is not None}
        return sorted(out)

    def _hist_summary(self, name: str, model: Optional[str] = None):
        h = self.hist(name, model=model)
        return (h if h is not None else StreamingHistogram()).summary()

    def report(self, stack: str) -> Dict[str, Any]:
        """The canonical cross-stack report (``repro.metrics/v1``)."""
        completed = self.counter(QUERIES_COMPLETED)
        submitted = self.counter(QUERIES_SUBMITTED)
        violations = self.counter(SLO_VIOLATIONS)
        shed = self.counter(QUERIES_SHED)
        hits, misses = self.counter(CACHE_HITS), self.counter(CACHE_MISSES)
        dur = self.duration
        rep = {
            "schema": SCHEMA,
            "stack": stack,
            "duration_s": dur,
            "queries": {
                "submitted": submitted,
                "completed": completed,
            },
            # a degenerate marked span (no marks, or a single event) has no
            # rate to derive — emit null rather than a misleading 0.0 qps,
            # so report consumers can tell "no throughput signal" from
            # "measured zero" (validated by repro.metrics.validate)
            "throughput_qps": (completed / dur) if dur > 0 else None,
            "latency_s": self._hist_summary(LATENCY),
            "slo": {
                "target_s": self.slo,
                "violations": violations,
                "rate": (violations / completed if completed else 0.0),
                # fraction of *submitted* queries answered within the SLO —
                # shed queries count against attainment, so admission control
                # can't game the metric by rejecting everything
                "attainment": ((completed - violations) / submitted
                               if submitted else 1.0),
            },
            "admission": {
                "shed": shed,
                "degraded": self.counter(QUERIES_DEGRADED),
                "shed_rate": shed / submitted if submitted else 0.0,
            },
            "cache": {
                "hits": hits,
                "misses": misses,
                "hit_rate": hits / (hits + misses) if (hits + misses) else 0.0,
            },
            "batch_size": self._hist_summary(BATCH_SIZE),
            "queue_depth": self._hist_summary(QUEUE_DEPTH),
            "stragglers": {
                "partial_queries": self.counter(STRAGGLER_PARTIAL),
                "dropped_models": self.counter(STRAGGLER_DROPPED),
            },
            # always present (all-zero when no fault plan is attached) so
            # the report key set is schema-stable across healthy and
            # faulted runs
            "faults": {
                "crashes": self.counter(FAULTS_CRASHES),
                "transient_errors": self.counter(FAULTS_TRANSIENT),
                "slow_batches": self.counter(FAULTS_SLOW),
                "failures": self.counter(MODEL_FAILURES),
                "detected": self.counter(FAULTS_DETECTED),
                "recovered": self.counter(FAULTS_RECOVERED),
                "requeued_queries": self.counter(FAULTS_REQUEUED),
                "retries": self.counter(FAULTS_RETRIES),
                "retry_exhausted": self.counter(FAULTS_RETRY_EXHAUSTED),
                "hedges": self.counter(FAULTS_HEDGES),
                "hedge_wins": self.counter(FAULTS_HEDGE_WINS),
            },
            "per_model": {
                m: {
                    "queries": self.counter(QUERIES_SUBMITTED, model=m),
                    # per-model prediction-cache counters (PredictionCache
                    # reports labeled hits/misses alongside the global pair)
                    "cache": self._model_cache(m),
                    # completions + end-to-end latency are tagged per model
                    # (LMServer does; the ensemble frontend completes
                    # queries across models, so these stay 0/empty there) —
                    # multi-model cluster reports can now separate LM
                    # completions from frontend ones
                    "completed": self.counter(QUERIES_COMPLETED, model=m),
                    "latency_s": self._hist_summary(LATENCY, model=m),
                    "batches": self.counter(BATCHES, model=m),
                    "service_s": self._hist_summary(SERVICE, model=m),
                    "batch_size": self._hist_summary(BATCH_SIZE, model=m),
                    # fault handling (DESIGN.md §14): injected failures this
                    # model's containers raised, plus the recovery work
                    # (re-dispatches, hedged duplicates) spent on it
                    "failures": self.counter(MODEL_FAILURES, model=m),
                    "retries": self.counter(FAULTS_RETRIES, model=m),
                    "hedges": self.counter(FAULTS_HEDGES, model=m),
                }
                for m in self._models()
            },
        }
        return rep

    def _model_cache(self, m: str) -> Dict[str, Any]:
        hits = self.counter(CACHE_HITS, model=m)
        misses = self.counter(CACHE_MISSES, model=m)
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / (hits + misses) if (hits + misses) else 0.0,
        }

    def report_json(self, stack: str, **extra: Any) -> str:
        """Stable JSON rendering — byte-identical for identical runs."""
        rep = self.report(stack)
        rep.update(extra)
        return json.dumps(rep, sort_keys=True, indent=2)
