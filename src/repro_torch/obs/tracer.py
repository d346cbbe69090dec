"""Clock-agnostic, seed-deterministic span tracer (DESIGN.md §13).

Clipper's evaluation is *measured* behaviour, but an aggregate report can
only say that p99 degraded — not where the deadline went. This module is
the per-query answer: a ``Tracer`` records ``Span``s for every phase of a
query's lifecycle (cache probe, admission, queue wait, batch service,
straggler hold, pipeline stages, LM prefill/decode) into a bounded
ring-buffer ``SpanLog``, and accumulates an exact *latency attribution* —
the fraction of end-to-end latency spent in each component — that both
serving stacks surface in their ``repro.metrics/v1`` reports.

Design rules, mirroring ``core.metrics``:

* **Clock-agnostic** — the tracer never reads time; every call takes an
  explicit timestamp from whatever owns the timeline (``VirtualClock`` in
  calibrated simulation, wall clock otherwise). Under a virtual clock the
  span log and the attribution are *exact* and byte-identical per seed.
* **Head-based, seed-deterministic sampling** — whether a trace is
  recorded is decided once at its root from ``hash(seed, trace_id)``, so
  a sample rate < 1 keeps whole traces (never orphan child spans) and two
  runs of the same seed sample the identical subset.
* **Bounded memory** — the span log is a ring buffer: the newest
  ``capacity`` completed spans are retained, the overwritten count is
  reported as ``dropped`` (never silently).
* **Step spans** — an engine's own steps (``LMServer``'s admissions and
  decode steps) are spans outside any request: trace id 0, as
  ``global_event``'s, opened by :meth:`Tracer.start_step` with children
  through ``start_span``. They ignore ``sample_rate``, count as no trace
  and enter no attribution, and keep a ring of their own of the same
  ``capacity``, so they never evict a request's span (``summary()``
  counts both rings; ``spans()`` lists the requests' ring, then theirs).
  A tracer built with ``engine=False`` (the reference's has no such
  spans) is asked for none. While a
  ``torch.profiler`` records, each step span is also a
  ``record_function`` range of its name, nested as the span is, so the
  engine's phases sit on the profiler's timeline beside the device ops.

The serialized form is the ``repro.trace/v1`` schema (``Tracer.to_json``),
convertible to Chrome ``trace_event`` JSON by ``python -m repro.obs.export``
for flamegraph inspection in ``about:tracing`` / Perfetto.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, List, Optional

TRACE_SCHEMA = "repro.trace/v1"

_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """Deterministic 64-bit mixer (SplitMix64 finalizer) — the sampling
    hash, chosen for platform-independent integer arithmetic."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return (x ^ (x >> 31)) & _MASK


def sample_decision(seed: int, trace_id: int, rate: float) -> bool:
    """Head-based sampling decision: a pure function of (seed, trace_id),
    uniform over traces at the given rate."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    u = _splitmix64((seed & _MASK) ^ _splitmix64(trace_id)) / float(1 << 64)
    return u < rate


class Span:
    """One timed interval (or instant event) of a traced query.

    ``budget_s`` is the span's share of the query's deadline budget where
    one is defined (the SLO for roots, the planner's stage share for
    pipeline stages, the AIMD controller's latency budget for batch
    service, the prefill/decode SLO split for the LM engine) — ``None``
    where no budget is carved out."""

    __slots__ = ("span_id", "trace_id", "parent_id", "name", "component",
                 "start", "end", "kind", "budget_s", "attrs", "range")

    def __init__(self, span_id: int, trace_id: int, parent_id: Optional[int],
                 name: str, component: str, start: float,
                 end: Optional[float] = None, kind: str = "span",
                 budget_s: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.component = component
        self.start = float(start)
        self.end = end
        self.kind = kind
        self.budget_s = budget_s
        self.attrs = attrs
        # a step span's open profiler range, if one is recording
        self.range = None

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "span_id": self.span_id,
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "component": self.component,
            "start": self.start,
            "end": self.end,
            "kind": self.kind,
            "budget_s": self.budget_s,
            "attrs": self.attrs or {},
        }


class SpanLog:
    """Bounded ring buffer of completed spans.

    Spans are appended in completion order (deterministic under a virtual
    clock). When full, the oldest span is overwritten and counted in
    ``dropped`` — memory stays bounded no matter how long the run."""

    def __init__(self, capacity: int = 1 << 16):
        assert capacity > 0
        self.capacity = capacity
        self._buf: List[Optional[Span]] = [None] * capacity
        self._n = 0                     # total spans ever appended

    def append(self, span: Span) -> None:
        self._buf[self._n % self.capacity] = span
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def spans(self) -> List[Span]:
        """Retained spans, oldest first."""
        if self._n <= self.capacity:
            return [s for s in self._buf[:self._n]]
        h = self._n % self.capacity
        return self._buf[h:] + self._buf[:h]        # type: ignore[return-value]


def _open_range(span: Span) -> None:
    """Open ``span``'s profiler range where a profiler records."""
    import torch
    if torch._C._autograd._profiler_enabled():
        span.range = torch.profiler.record_function(span.name)
        span.range.__enter__()


class Tracer:
    """Per-query span recording + exact latency attribution.

    All methods tolerate ``parent=None`` (an unsampled trace) by doing
    nothing and propagating ``None``, so instrumentation sites only guard
    on ``tracer is not None`` once, at trace start.

    ``engine``: whether an engine records its step spans here
    (:meth:`start_step`); off where a span log is held to the
    reference's."""

    def __init__(self, *, sample_rate: float = 1.0, seed: int = 0,
                 capacity: int = 1 << 16, engine: bool = True):
        assert 0.0 <= sample_rate <= 1.0
        self.sample_rate = sample_rate
        self.seed = seed
        self.engine = engine
        self.log = SpanLog(capacity)
        self.step_log = SpanLog(capacity)
        self._sids = itertools.count(1)
        self._tids = itertools.count(1)
        self.traces = 0                 # traces started (incl. unsampled)
        self.sampled = 0
        # exact attribution accumulators (completed, attributed traces)
        self._attr_seconds: Dict[str, float] = {}
        self._attr_latency = 0.0
        self._attr_queries = 0

    # -- span lifecycle -------------------------------------------------
    def start_trace(self, name: str, component: str, t: float, *,
                    budget_s: Optional[float] = None,
                    attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Open a root span; returns ``None`` when the trace is not sampled
        (the id is still consumed, so later sampling decisions never shift)."""
        tid = next(self._tids)
        self.traces += 1
        if not sample_decision(self.seed, tid, self.sample_rate):
            return None
        self.sampled += 1
        return Span(next(self._sids), tid, None, name, component, t,
                    kind="span", budget_s=budget_s,
                    attrs=dict(attrs) if attrs else {})

    def start_span(self, parent: Optional[Span], name: str, component: str,
                   t: float, *, budget_s: Optional[float] = None,
                   attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        if parent is None:
            return None
        s = Span(next(self._sids), parent.trace_id, parent.span_id,
                 name, component, t, kind="span", budget_s=budget_s,
                 attrs=dict(attrs) if attrs else None)
        if parent.trace_id == 0:
            _open_range(s)
        return s

    def start_step(self, name: str, component: str, t: float,
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Open a step span: an engine's own step (an admission, a decode
        step), outside any trace — trace id 0, never sampled out. Its
        children come from ``start_span``; ``end_span`` closes each."""
        s = Span(next(self._sids), 0, None, name, component, t, kind="span",
                 attrs=dict(attrs) if attrs else None)
        _open_range(s)
        return s

    def end_span(self, span: Optional[Span], t: float,
                 **attrs: Any) -> None:
        """Close a span (appends it to the log). Extra attrs merge in."""
        if span is None:
            return
        span.end = float(t)
        if attrs:
            span.attrs = {**(span.attrs or {}), **attrs}
        if span.trace_id == 0:          # a step span or its child
            if span.range is not None:
                span.range.__exit__(None, None, None)
                span.range = None
            self.step_log.append(span)
        else:
            self.log.append(span)

    def add_span(self, parent: Optional[Span], name: str, component: str,
                 start: float, end: float, *,
                 budget_s: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Record a fully-known (already completed) child span."""
        s = self.start_span(parent, name, component, start,
                            budget_s=budget_s, attrs=attrs)
        self.end_span(s, end)
        return s

    def event(self, parent: Optional[Span], name: str, component: str,
              t: float, attrs: Optional[Dict[str, Any]] = None) -> None:
        """Instant event under a trace (cache hit/miss, admission verdict,
        deadline firing)."""
        if parent is None:
            return
        self.log.append(Span(next(self._sids), parent.trace_id,
                             parent.span_id, name, component, t, end=float(t),
                             kind="event",
                             attrs=dict(attrs) if attrs else None))

    def global_event(self, name: str, component: str, t: float,
                     attrs: Optional[Dict[str, Any]] = None) -> None:
        """Instant event outside any trace (batch dispatch, prefill
        compile) — trace id 0 in the log."""
        self.log.append(Span(next(self._sids), 0, None, name, component, t,
                             end=float(t), kind="event",
                             attrs=dict(attrs) if attrs else None))

    def end_trace(self, root: Optional[Span], t: float, *,
                  attribution: Optional[Dict[str, float]] = None,
                  status: str = "ok",
                  attrs: Optional[Dict[str, Any]] = None) -> None:
        """Close a root span. ``attribution`` maps component -> exact
        seconds of the query's end-to-end latency; it is stored on the root
        span and accumulated into the run-level ``latency_attribution``
        (fractions summing to 1 for every attributed query)."""
        if root is None:
            return
        root.end = float(t)
        a = {**(root.attrs or {}), "status": status}
        if attrs:
            a.update(attrs)
        if attribution is not None:
            a["attribution"] = dict(sorted(attribution.items()))
            latency = root.end - root.start
            self._attr_latency += latency
            self._attr_queries += 1
            for comp, sec in attribution.items():
                self._attr_seconds[comp] = (
                    self._attr_seconds.get(comp, 0.0) + sec)
        root.attrs = a
        self.log.append(root)

    # -- reading --------------------------------------------------------
    def spans(self) -> List[Span]:
        return self.log.spans() + self.step_log.spans()

    def attribution_report(self) -> Dict[str, Any]:
        """Run-level latency attribution: for the attributed (completed,
        nonzero-latency) queries, the share of total end-to-end latency
        each component consumed. Fractions sum to 1 exactly (the per-query
        decompositions are exact partitions of each query's latency)."""
        total = self._attr_latency
        return {
            "queries": self._attr_queries,
            "total_latency_s": total,
            "components": {
                comp: {
                    "seconds": sec,
                    "fraction": (sec / total) if total > 0 else 0.0,
                }
                for comp, sec in sorted(self._attr_seconds.items())
            },
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "sample_rate": self.sample_rate,
            "seed": self.seed,
            "traces": self.traces,
            "sampled_traces": self.sampled,
            "spans": len(self.log) + len(self.step_log),
            "spans_total": self.log.total + self.step_log.total,
            "dropped": self.log.dropped + self.step_log.dropped,
            "capacity": self.log.capacity,
        }

    def to_dict(self) -> Dict[str, Any]:
        """The ``repro.trace/v1`` document."""
        return {
            "schema": TRACE_SCHEMA,
            **self.summary(),
            "attribution": self.attribution_report(),
            "spans": [s.to_dict() for s in self.spans()],
        }

    def to_json(self) -> str:
        """Stable JSON rendering — byte-identical for identical runs."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)
