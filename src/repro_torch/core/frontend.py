"""The Clipper frontend (paper §3), counterpart of ``repro.core.frontend``:
the application-facing serving loop that composes the model abstraction
layer (cache → adaptive batching → containers) with the model selection
layer (select → combine → observe, straggler-safe).

Implemented as a discrete-event loop with an injectable clock:

* wall-clock mode — containers execute for real and completion times come
  from measured execution (overhead benches, quickstart);
* calibrated-simulation mode — containers still execute (real outputs) but
  completion times come from their latency models, letting one CPU core
  faithfully replay cluster-scale scenarios (replica scaling, stragglers —
  paper Figs 6 & 9; documented in DESIGN.md §8).
"""

from __future__ import annotations

import heapq
import itertools
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.batching import AIMDController, BatchQueue
from repro_torch.core.cache import PredictionCache
from repro_torch.core.containers import (ContainerCrashed, ReplicaSet,
                                         TorchModelContainer, TransientError)
from repro_torch.core.interfaces import Feedback, Prediction, Query
from repro_torch.core.metrics import (
    CACHE_HITS, CACHE_MISSES, FAULTS_CRASHES, FAULTS_DETECTED,
    FAULTS_HEDGE_WINS, FAULTS_HEDGES, FAULTS_RECOVERED, FAULTS_REQUEUED,
    FAULTS_RETRIES, FAULTS_RETRY_EXHAUSTED, FAULTS_SLOW, FAULTS_TRANSIENT,
    MetricsRegistry, MODEL_FAILURES, PIPELINE_STAGES_DEGRADED,
    PIPELINE_STAGES_SHED, QUERIES_COMPLETED, QUERIES_DEGRADED, QUERIES_ROUTED,
    QUERIES_SHED, QUERIES_SUBMITTED)
from repro_torch.core.selection import Exp3Policy, Exp4Policy
from repro_torch.core.straggler import record_stragglers


@dataclass(order=True)
class _Event:
    at: float
    seq: int
    # 'complete' | 'deadline' | 'timeout' | 'hedge' | 'retry'
    kind: str = field(compare=False)
    payload: Any = field(compare=False, default=None)


class Clipper:
    """End-to-end prediction serving frontend."""

    def __init__(self, replica_sets: Dict[str, ReplicaSet], policy, *,
                 slo: float = 0.020, cache_size: int = 4096,
                 loss_fn: Optional[Callable[[Any, Any], float]] = None,
                 contextual_store=None, seed: int = 0,
                 use_cache: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 router: Optional[Callable[[ReplicaSet, float], int]] = None,
                 admission=None, tracer=None, recovery=None, audit=None):
        self.replica_sets = replica_sets
        self.policy = policy
        self.slo = slo
        # failure detection + hedged-retry recovery (repro.faults,
        # DESIGN.md §14): None = recovery off. With no fault plan attached
        # either, dispatch takes the exact original path — zero per-query
        # overhead.
        self.recovery = recovery
        # control-plane hooks (repro.cluster, DESIGN.md §10): ``router``
        # maps (replica_set, now) -> replica index for each enqueue;
        # ``admission`` may narrow or reject the chosen ensemble per query
        self.router = router
        self.admission = admission
        # span tracing (repro.obs, DESIGN.md §13): None = tracing off, no
        # per-query overhead beyond these ``is not None`` checks
        self.tracer = tracer
        # control-plane decision audit (repro.obs.audit, DESIGN.md §15):
        # None = off, same zero-overhead discipline as the tracer
        self.audit = audit
        # fleet-sampler probe state: previous cumulative counter values,
        # touched only when a FleetSampler polls timeseries_probe
        self._ts_prev: Dict[str, float] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry(slo)
        self.cache = (PredictionCache(cache_size, metrics=self.metrics,
                                      tracer=tracer)
                      if use_cache else None)
        # batching + cache layers report through the same registry, so both
        # serving stacks emit one telemetry schema (metrics.py)
        for rs in replica_sets.values():
            rs.attach_metrics(self.metrics)
            if tracer is not None:
                rs.attach_tracer(tracer)
        self.loss_fn = loss_fn or _default_loss
        self.contextual = contextual_store
        self.rng = np.random.default_rng(seed)
        self.policy_state = policy.init()
        self._events: List[_Event] = []
        self._eseq = itertools.count()
        self._qseq = itertools.count()
        # in-flight batch registry for the failure detector: bid ->
        # {mid, ri, batch, at, done}. Only populated in recovery mode.
        self._batches: Dict[int, dict] = {}
        self._bseq = itertools.count()
        # (mid, ri) -> virtual time a recovery probe last cleared the
        # replica: timeouts of batches dispatched before that are stale
        # evidence and must not re-condemn the recovered replica
        self._cleared: Dict[Tuple[str, int], float] = {}
        self.now = 0.0
        self._pending: Dict[int, dict] = {}     # qid -> bookkeeping
        self.results: Dict[int, Prediction] = {}
        self.shed_qids: set = set()     # admission-rejected; never in results
        self._feedback_hits = 0
        self._feedback_misses = 0

    # ------------------------------------------------------------------
    # application API
    # ------------------------------------------------------------------
    def submit(self, x, *, context_id: int = 0,
               arrival_time: Optional[float] = None) -> int:
        """Issue a prediction request; returns the query id."""
        at = self.now if arrival_time is None else arrival_time
        self.now = max(self.now, at)
        self.metrics.inc(QUERIES_SUBMITTED)
        self.metrics.mark(at)
        qid = next(self._qseq)
        q = Query(qid, x, context_id, at, deadline=at + self.slo)
        trace = None
        if self.tracer is not None:
            # root span: the whole query lifecycle; budget = the full SLO
            trace = self.tracer.start_trace(
                "query", "frontend", at, budget_s=self.slo,
                attrs={"qid": qid})
        chosen = self.policy.select(self._policy_state_for(q), x, self.rng)
        cached, uncached = self._probe_and_admit(q, chosen, rescope=False,
                                                 trace=trace)
        if not uncached and not cached:
            # shed: never enqueued, never completes — callers checking
            # ``results[qid]`` must consult ``shed_qids`` first
            self.shed_qids.add(qid)
            if self.tracer is not None:
                self.tracer.end_trace(trace, self.now, status="shed")
            return qid
        entry = {"query": q, "need": set(cached) | set(uncached),
                 "preds": cached, "done": False, "trace": trace}
        self._start_entry(entry, uncached)
        return qid

    def submit_stage(self, model_ids: Sequence[str], x, *, deadline: float,
                     finalize: Callable[[Dict[str, Any], Tuple[str, ...], bool],
                                        None],
                     arrival_time: Optional[float] = None,
                     trace_parent=None) -> int:
        """Low-level stage job for DAG pipelines (repro.pipeline): evaluate
        ``x`` on ``model_ids`` under an absolute per-stage ``deadline`` and
        call ``finalize(preds, missing_models, at_deadline)`` exactly once —
        when every model returned, or at the deadline with whatever arrived
        (stage-level straggler mitigation, same semantics as ensembles).

        Stage jobs ride the ordinary machinery: the prediction cache is
        consulted first (this is the pipeline's intermediate-result cache —
        a hit skips the model entirely), admission control may narrow or
        shed the stage, and batching/routing are untouched. Unlike
        ``submit``, no global query counters move here: the pipeline
        executor accounts queries at pipeline granularity. A stage shed
        entirely with nothing cached finalizes immediately with empty preds
        — the executor decides what an empty stage means."""
        at = self.now if arrival_time is None else arrival_time
        self.now = max(self.now, at)
        self.metrics.mark(at)
        qid = next(self._qseq)
        q = Query(qid, x, 0, at, deadline=deadline)
        cached, uncached = self._probe_and_admit(q, model_ids, rescope=True,
                                                 trace=trace_parent)
        entry = {"query": q, "need": set(cached) | set(uncached),
                 "preds": cached, "done": False, "finalize": finalize,
                 "trace": trace_parent}
        self._start_entry(entry, uncached)
        return qid

    def _probe_and_admit(self, q: Query, model_ids: Sequence[str], *,
                         rescope: bool,
                         trace=None) -> Tuple[Dict[str, Any], List[str]]:
        """The cache-probe + admission core both submit paths share:
        returns ``(cached predictions, models still to evaluate)``.
        Admission (when configured) drops models — or everything — whose
        deadline is already unmeetable given the backlog (DESIGN.md §10).

        ``rescope=True`` (stage jobs) records admission's shed/degraded
        decisions under stage-level names, so ``admission.shed`` stays
        one-per-*pipeline*-query (the executor accounts those) and
        ``completed + shed == submitted`` keeps holding."""
        cached: Dict[str, Any] = {}
        uncached: List[str] = []
        for mid in model_ids:
            if self.cache is not None and self.cache.request(
                    mid, q.x, parent=trace, now=self.now):
                cached[mid] = self.cache.fetch(mid, q.x)
            else:
                uncached.append(mid)
        if self.admission is not None and uncached:
            counters = ({"shed_counter": PIPELINE_STAGES_SHED,
                         "degraded_counter": PIPELINE_STAGES_DEGRADED}
                        if rescope else {})
            uncached = self.admission.admit(self, q, uncached,
                                            cached=bool(cached),
                                            trace_parent=trace, **counters)
        return cached, uncached

    def _start_entry(self, entry: dict, uncached: Sequence[str]) -> None:
        """Register a pending entry, route its uncached models, arm the
        deadline, and finalize immediately if nothing needs computing."""
        q: Query = entry["query"]
        self._pending[q.query_id] = entry
        trace = entry.get("trace")
        if trace is not None:
            entry["tqueue"] = {}
        for mid in uncached:
            ri = self._route(mid, q)
            if trace is not None:
                # queue span opens at enqueue; _dispatch_ready closes it
                # when the query leaves the replica's batch queue. Routers
                # exposing ``last_attrs`` (LECT) annotate their prediction.
                attrs = {"model": mid, "replica": ri}
                attrs.update(getattr(self.router, "last_attrs", None) or {})
                entry["tqueue"][mid] = self.tracer.start_span(
                    trace, "queue", "frontend.queue", self.now, attrs=attrs)
        if uncached:
            self._push(q.deadline, "deadline", q.query_id)
        self._maybe_finalize(entry)

    def feedback(self, fb: Feedback) -> None:
        """Join feedback with cached predictions and update selection state
        (paper §4.2 + §5). Missing predictions are recomputed — the cost the
        cache exists to avoid."""
        preds: Dict[str, Any] = {}
        for mid, rs in self.replica_sets.items():
            y = self.cache.fetch(mid, fb.x) if self.cache is not None else None
            if y is None:
                self._feedback_misses += 1
                y = rs.replicas[0].pred_batch([fb.x])[0]
                if self.cache is not None:
                    self.cache.put(mid, fb.x, y)
            else:
                self._feedback_hits += 1
            preds[mid] = y
        losses = {mid: self.loss_fn(y, fb.y_true) for mid, y in preds.items()}
        if self.contextual is not None:
            self._observe_contextual(fb, losses)
        else:
            self.policy_state = self.policy.observe(
                self.policy_state, fb.x, losses, preds)

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------
    def run(self, until: Optional[float] = None) -> None:
        """Process events and dispatch ready batches until quiescent (or
        until the given virtual time)."""
        while True:
            self._dispatch_ready()
            if not self._events:
                break
            ev = heapq.heappop(self._events)
            if until is not None and ev.at > until:
                heapq.heappush(self._events, ev)
                break
            self.now = max(self.now, ev.at)
            if ev.kind == "complete":
                self._on_complete(**ev.payload)
            elif ev.kind == "deadline":
                self._on_deadline(ev.payload)
            elif ev.kind == "timeout":
                self._on_timeout(ev.payload)
            elif ev.kind == "hedge":
                self._on_hedge(ev.payload)
            elif ev.kind == "retry":
                self._on_retry(*ev.payload)

    def _dispatch_ready(self) -> None:
        recovering = self.recovery is not None
        if recovering:
            self._probe_recovered()
        progressed = True
        while progressed:
            progressed = False
            for mid, rs in self.replica_sets.items():
                for ri, queue in enumerate(rs.queues):
                    if not queue.ready(self.now):
                        continue
                    if (rs.free_at[ri] > self.now or rs.replicas[ri].fail
                            or rs.retired[ri]):
                        continue
                    batch = queue.next_batch(self.now)
                    if not batch:
                        continue
                    if recovering or rs.has_faults:
                        self._dispatch_fault_aware(mid, rs, ri, queue, batch)
                        progressed = True
                        continue
                    outs, service = rs.replicas[ri].pred_batch_timed(
                        [q.x for q in batch])
                    done_at = self.now + service
                    rs.free_at[ri] = done_at
                    if self.tracer is not None:
                        self._trace_dispatch(
                            mid, ri, batch, done_at,
                            getattr(queue.controller, "slo", None))
                    self._push(done_at, "complete", dict(
                        mid=mid, ri=ri, batch=batch, outs=outs,
                        service=service, size=len(batch)))
                    progressed = True

    # ------------------------------------------------------------------
    # fault handling (repro.faults, DESIGN.md §14)
    # ------------------------------------------------------------------
    def _dispatch_fault_aware(self, mid: str, rs: ReplicaSet, ri: int,
                              queue: BatchQueue,
                              batch: List[Query]) -> None:
        """Dispatch one batch on a replica that may crash, error, or run
        degraded. Failure semantics: a crash *silently loses* the batch
        (no completion event — only the armed timeout can notice), a
        transient error fails fast (retries schedule immediately), and a
        successful dispatch arms the detector timeout plus (optionally) a
        straggler hedge."""
        pol = self.recovery
        faults = rs.replicas[ri].faults
        if (faults is not None
                and faults.multiplier(self.now) != 1.0):
            self.metrics.inc_both(FAULTS_SLOW, model=mid)
        # arm-time thresholds come from *pre-dispatch* history: the
        # container's synchronous stats update would otherwise leak this
        # very batch's (possibly degraded) service time into the estimate,
        # inflating the detector/hedge deadlines it is supposed to police
        detect_in = (self._detect_after(rs, ri, len(batch), pol)
                     if pol is not None else 0.0)
        hedge_in = (self._hedge_after(rs, ri, len(batch), pol)
                    if pol is not None and pol.hedge else 0.0)
        try:
            outs, service = rs.replicas[ri].pred_batch_timed(
                [q.x for q in batch], now=self.now)
        except ContainerCrashed:
            self.metrics.inc_both(FAULTS_CRASHES, model=mid)
            self.metrics.inc_both(MODEL_FAILURES, model=mid)
            self._close_queue_spans(mid, batch)
            if self.tracer is not None:
                self.tracer.global_event(
                    "fault.crash", "faults", self.now,
                    attrs={"model": mid, "replica": ri,
                           "queries": len(batch)})
            if pol is not None:
                bid = next(self._bseq)
                self._batches[bid] = dict(mid=mid, ri=ri, batch=batch,
                                          at=self.now, done=False)
                self._push(self.now + detect_in, "timeout", bid)
            return
        except TransientError:
            self.metrics.inc_both(FAULTS_TRANSIENT, model=mid)
            self.metrics.inc_both(MODEL_FAILURES, model=mid)
            self._close_queue_spans(mid, batch)
            if self.tracer is not None:
                self.tracer.global_event(
                    "fault.transient", "faults", self.now,
                    attrs={"model": mid, "replica": ri,
                           "queries": len(batch)})
            if pol is not None:
                # fail-fast: the error response arrives immediately, so
                # retries back off from *now* rather than from detection
                self._schedule_retries(mid, batch)
            return
        done_at = self.now + service
        rs.free_at[ri] = done_at
        if self.tracer is not None:
            self._trace_dispatch(mid, ri, batch, done_at,
                                 getattr(queue.controller, "slo", None))
        bid = None
        if pol is not None:
            bid = next(self._bseq)
            self._batches[bid] = dict(mid=mid, ri=ri, batch=batch,
                                      at=self.now, done=False)
            self._push(self.now + detect_in, "timeout", bid)
            if pol.hedge:
                self._push(self.now + hedge_in, "hedge", bid)
        self._push(done_at, "complete", dict(
            mid=mid, ri=ri, batch=batch, outs=outs, service=service,
            size=len(batch), bid=bid))

    def _close_queue_spans(self, mid: str, batch: Sequence[Query]) -> None:
        """A failed dispatch still pulled the batch out of its queue: close
        the queue spans (truncated) so every started span ends. A later
        retry opens a fresh one."""
        if self.tracer is None:
            return
        for q in batch:
            entry = self._pending.get(q.query_id)
            if entry is None or entry.get("trace") is None:
                continue
            self.tracer.end_span(entry["tqueue"].pop(mid, None), self.now,
                                 truncated=True)

    def _detect_after(self, rs: ReplicaSet, ri: int, size: int,
                      pol) -> float:
        """Detector timeout for a batch of ``size`` dispatched now: a
        generous multiple of the batch's *expected completion* (per-query
        service estimate × batch size — est_service is per query, service
        is per batch), floored so cold replicas (no history) are not
        instantly condemned."""
        floor = pol.min_timeout if pol.min_timeout is not None else self.slo
        return max(pol.detect_factor * rs.est_service(ri, 0.0) * size, floor)

    def _hedge_after(self, rs: ReplicaSet, ri: int, size: int,
                     pol) -> float:
        floor = (pol.hedge_min if pol.hedge_min is not None
                 else self.slo / 2.0)
        return max(pol.hedge_factor * rs.est_service(ri, 0.0) * size, floor)

    def _probe_recovered(self) -> None:
        """Health-probe suspected replicas each dispatch round; recovered
        ones rejoin routing. While a suspected replica stays down, any work
        stranded on its queue (router fallback under total failure) drains
        to a live replica as soon as one exists."""
        for mid, rs in self.replica_sets.items():
            if not rs.suspected:
                continue
            for ri in rs.probe_recovered(self.now):
                self._cleared[(mid, ri)] = self.now
                self.metrics.inc_both(FAULTS_RECOVERED, model=mid)
                if self.tracer is not None:
                    self.tracer.global_event(
                        "fault.recovered", "faults", self.now,
                        attrs={"model": mid, "replica": ri})
                if self.audit is not None:
                    self.audit.record(self.now, "faults", "recover",
                                      model=mid, evidence={"replica": ri})
            for ri in sorted(rs.suspected):
                if rs.queues[ri]:
                    self._drain_suspect(mid, rs, ri)

    def _drain_suspect(self, mid: str, rs: ReplicaSet, ri: int) -> None:
        targets = [i for i in rs.routable() if i != ri]
        if not targets:
            return
        tgt = min(targets, key=lambda i: (len(rs.queues[i]), i))
        moved = rs.queues[ri].requeue_to(rs.queues[tgt],
                                         keep=self._query_live)
        if moved:
            self.metrics.inc_both(FAULTS_REQUEUED, n=moved, model=mid)

    def _query_live(self, q: Query) -> bool:
        entry = self._pending.get(q.query_id)
        return entry is not None and not entry["done"]

    def _on_timeout(self, bid: int) -> None:
        """A dispatched batch missed its expected completion: declare the
        replica down (out of routing until a health probe clears it), drain
        its queued backlog to a live replica, and retry the lost queries."""
        rec = self._batches.pop(bid, None)
        if rec is None or rec["done"]:
            return
        mid, ri = rec["mid"], rec["ri"]
        rs = self.replica_sets[mid]
        stale = rec["at"] < self._cleared.get((mid, ri), float("-inf"))
        if not stale and not rs.replicas[ri].fail:   # first detection wins
            rs.replicas[ri].fail = True
            rs.suspected.add(ri)
            self.metrics.inc_both(FAULTS_DETECTED, model=mid)
            if self.tracer is not None:
                self.tracer.global_event(
                    "fault.detected", "faults", self.now,
                    attrs={"model": mid, "replica": ri})
            if self.audit is not None:
                self.audit.record(
                    self.now, "faults", "detect", model=mid,
                    evidence={"replica": ri, "dispatched_at": rec["at"],
                              "batch": len(rec["batch"]),
                              "overdue_s": self.now - rec["at"]})
            self._drain_suspect(mid, rs, ri)
        self._schedule_retries(mid, rec["batch"])

    def _schedule_retries(self, mid: str, batch: Sequence[Query]) -> None:
        """Re-dispatch lost queries under the per-query per-model retry
        budget with exponential backoff; exhausted queries are left to
        straggler mitigation (render without the model at the deadline)."""
        pol = self.recovery
        if pol is None:
            return
        for q in batch:
            entry = self._pending.get(q.query_id)
            if (entry is None or entry["done"]
                    or mid in entry["preds"] or mid not in entry["need"]):
                continue
            tries = entry.setdefault("retries", {})
            n = tries.get(mid, 0)
            if n >= pol.max_retries:
                self.metrics.inc_both(FAULTS_RETRY_EXHAUSTED, model=mid)
                if self.tracer is not None and entry.get("trace") is not None:
                    self.tracer.event(entry["trace"], "retry_exhausted",
                                      "frontend.fault", self.now,
                                      attrs={"model": mid, "attempts": n})
                continue
            tries[mid] = n + 1
            self._push(self.now + pol.backoff_base * (2 ** n), "retry",
                       (mid, q.query_id))

    def _on_retry(self, mid: str, qid: int) -> None:
        entry = self._pending.get(qid)
        if entry is None or entry["done"] or mid in entry["preds"]:
            return
        self.metrics.inc_both(FAULTS_RETRIES, model=mid)
        q: Query = entry["query"]
        if self.audit is not None:
            self.audit.record(
                self.now, "faults", "retry", model=mid,
                evidence={"qid": qid, "attempt": entry["retries"][mid],
                          "slack_s": (q.deadline - self.now
                                      if q.deadline is not None else None)})
        ri = self._route(mid, q)
        if self.tracer is not None and entry.get("trace") is not None:
            self.tracer.event(entry["trace"], "retry", "frontend.fault",
                              self.now, attrs={"model": mid, "replica": ri,
                                               "attempt":
                                               entry["retries"][mid]})
            old = entry["tqueue"].pop(mid, None)
            self.tracer.end_span(old, self.now, truncated=True)
            entry["tqueue"][mid] = self.tracer.start_span(
                entry["trace"], "queue", "frontend.queue", self.now,
                attrs={"model": mid, "replica": ri, "retry": True})

    def _on_hedge(self, bid: int) -> None:
        """The batch outlived its hedge threshold but is not (yet) presumed
        dead: re-enqueue its unanswered queries once on the best alternate
        replica; whichever copy completes first wins."""
        rec = self._batches.get(bid)
        if rec is None or rec["done"]:
            return
        mid, ri = rec["mid"], rec["ri"]
        rs = self.replica_sets[mid]
        alts = [i for i in rs.routable() if i != ri]
        if not alts:
            return
        alt = min(alts, key=lambda i: (rs.expected_completion(i, self.now),
                                       len(rs.queues[i]), i))
        hedged = 0
        for q in rec["batch"]:
            entry = self._pending.get(q.query_id)
            if (entry is None or entry["done"] or mid in entry["preds"]
                    or mid in entry.get("hedge_from", {})):
                continue            # one hedge per query per model
            entry.setdefault("hedge_from", {})[mid] = ri
            rs.queues[alt].put(q)
            hedged += 1
            self.metrics.inc_both(FAULTS_HEDGES, model=mid)
            if self.tracer is not None and entry.get("trace") is not None:
                self.tracer.event(entry["trace"], "hedge", "frontend.fault",
                                  self.now,
                                  attrs={"model": mid, "from": ri,
                                         "to": alt})
                if entry["tqueue"].get(mid) is None:
                    entry["tqueue"][mid] = self.tracer.start_span(
                        entry["trace"], "queue", "frontend.queue", self.now,
                        attrs={"model": mid, "replica": alt, "hedge": True})
        if hedged and self.audit is not None:
            self.audit.record(
                self.now, "faults", "hedge", model=mid,
                evidence={"from": ri, "to": alt, "queries": hedged,
                          "batch_age_s": self.now - rec["at"],
                          "alt_ect_s": rs.expected_completion(alt, self.now)})

    def _trace_dispatch(self, mid: str, ri: int, batch: Sequence[Query],
                        done_at: float, budget: Optional[float]) -> None:
        """Per-query trace bookkeeping at batch dispatch: close the queue
        span, record the service span (budget = the batch controller's
        latency target), and remember dispatch/completion times for
        finalize-time attribution."""
        for q in batch:
            entry = self._pending.get(q.query_id)
            if entry is None or entry.get("trace") is None:
                continue
            self.tracer.end_span(entry["tqueue"].pop(mid, None), self.now)
            self.tracer.add_span(
                entry["trace"], "service", "frontend.service", self.now,
                done_at, budget_s=budget,
                attrs={"model": mid, "replica": ri, "batch": len(batch)})
            if mid not in entry["preds"]:
                # a hedged duplicate dispatching after the primary already
                # answered must not overwrite the winner's timestamps —
                # attribution walks the *used* prediction's critical path
                entry.setdefault("tdisp", {})[mid] = self.now
                entry.setdefault("tdone", {})[mid] = done_at

    def _on_complete(self, mid, ri, batch, outs, service, size,
                     bid=None) -> None:
        if bid is not None:
            rec = self._batches.pop(bid, None)
            if rec is not None:
                rec["done"] = True
        rs = self.replica_sets[mid]
        rs.queues[ri].record(size, service)
        recovering = self.recovery is not None
        for q, y in zip(batch, outs):
            if self.cache is not None:
                self.cache.put(mid, q.x, y)
            entry = self._pending.get(q.query_id)
            if entry is None or entry["done"]:
                continue                      # already straggler-finalized
            if recovering:
                if mid in entry["preds"]:
                    continue          # first result won; drop the duplicate
                hedged_from = entry.get("hedge_from", {}).get(mid)
                if hedged_from is not None and hedged_from != ri:
                    self.metrics.inc_both(FAULTS_HEDGE_WINS, model=mid)
                if entry.get("trace") is not None:
                    # the winner's timestamps, whichever copy it was —
                    # keeps queue + service + straggler_wait == latency
                    # exact even when a hedge beats its primary
                    entry.setdefault("tdisp", {})[mid] = self.now - service
                    entry.setdefault("tdone", {})[mid] = self.now
            entry["preds"][mid] = y
            self._maybe_finalize(entry)

    def _on_deadline(self, qid: int) -> None:
        entry = self._pending.get(qid)
        if entry is None or entry["done"]:
            return
        # no predictions at all: mark late and leave pending; the *first*
        # model to return then renders immediately (latency SLO already
        # blown — recorded as violation) instead of waiting for the rest
        entry["late"] = True
        if self.tracer is not None and entry.get("trace") is not None:
            self.tracer.event(entry["trace"], "deadline", "frontend.slo",
                              self.now)
        if entry["preds"] or entry.get("finalize") is not None:
            # stage jobs finalize at the deadline with whatever arrived —
            # possibly nothing (every model crashed with its retries
            # exhausted): the executor must learn the stage failed rather
            # than wait forever on a completion that cannot come
            self._finalize(entry, at_deadline=True)

    def _maybe_finalize(self, entry) -> None:
        if entry["done"]:
            return
        if entry["need"] <= set(entry["preds"]):
            self._finalize(entry, at_deadline=False)
        elif entry.get("late") and entry["preds"]:
            # past the deadline with nothing rendered yet: a late partial
            # answer beats waiting out the stragglers (paper §5.2.2)
            self._finalize(entry, at_deadline=True)

    def _finalize(self, entry, *, at_deadline: bool) -> None:
        q: Query = entry["query"]
        preds = {m: p for m, p in entry["preds"].items()}
        # finalized entries leave the pending map — late completions find
        # nothing and skip (they still feed the cache); without this the
        # map grows with every query served, ~4x faster for stage jobs
        self._pending.pop(q.query_id, None)
        trace = entry.get("trace")
        if trace is not None:
            # models still queued at render time never served this query:
            # close their queue spans truncated (every started span ends)
            for span in entry.get("tqueue", {}).values():
                self.tracer.end_span(span, self.now, truncated=True)
            entry["tqueue"] = {}
        fin = entry.get("finalize")
        if fin is not None:
            # stage job (submit_stage): hand the arrived predictions to the
            # pipeline executor; global query accounting — and the stage
            # span wrapping this job — stay with it
            entry["done"] = True
            self.metrics.mark(self.now)
            fin(preds, tuple(sorted(entry["need"] - set(preds))), at_deadline)
            return
        s = self._policy_state_for(q)
        y, conf = self.policy.combine(s, q.x, preds)
        missing = tuple(sorted(entry["need"] - set(preds)))
        entry["done"] = True
        latency = self.now - q.arrival_time
        if trace is not None:
            self._end_query_trace(entry, q, latency, missing, at_deadline)
        self.metrics.mark(self.now)
        self.metrics.inc(QUERIES_COMPLETED)
        self.metrics.observe_latency(latency)
        record_stragglers(self.metrics, missing)
        self.results[q.query_id] = Prediction(
            q.query_id, y, conf, tuple(sorted(preds)),
            latency=latency,
            missing_models=missing)

    def _end_query_trace(self, entry, q: Query, latency: float,
                         missing: Tuple[str, ...],
                         at_deadline: bool) -> None:
        """Exact latency attribution (DESIGN.md §13): partition end-to-end
        latency along the *critical model* — the used prediction that
        finished last. queue + service + straggler_wait == latency, so the
        run-level fractions sum to 1."""
        done = {m: t for m, t in entry.get("tdone", {}).items()
                if m in entry["preds"]}
        attribution = None
        if latency > 0:
            if done:
                crit = max(done, key=lambda m: (done[m], m))
                attribution = {
                    "frontend.queue": entry["tdisp"][crit] - q.arrival_time,
                    "frontend.service": done[crit] - entry["tdisp"][crit],
                    "frontend.straggler_wait": self.now - done[crit],
                }
                if self.now > done[crit]:
                    self.tracer.add_span(
                        entry["trace"], "straggler_wait",
                        "frontend.straggler", done[crit], self.now,
                        attrs={"critical_model": crit})
            else:
                # rendered from cache alone at the deadline: every moment
                # of the latency was spent waiting on stragglers
                attribution = {"frontend.straggler_wait": latency}
        self.tracer.end_trace(
            entry["trace"], self.now, attribution=attribution,
            status="deadline" if at_deadline else "ok",
            attrs={"missing": len(missing)})

    # ------------------------------------------------------------------
    def _policy_state_for(self, q: Query):
        if self.contextual is not None:
            return self.contextual.state_for(q.context_id)
        return self.policy_state

    def _observe_contextual(self, fb: Feedback, losses: Dict[str, float]):
        ids = list(self.policy.model_ids)
        lvec = np.asarray([losses.get(m, 0.0) for m in ids], np.float32)
        if isinstance(self.policy, Exp3Policy):
            i = int(np.argmin(lvec))  # feedback for evaluated model only
            self.contextual.observe_exp3(np.asarray([fb.context_id]),
                                         np.asarray([i]), lvec[i:i + 1])
        else:
            self.contextual.observe_exp4(np.asarray([fb.context_id]),
                                         lvec[None, :])

    def _route(self, mid: str, q: Query) -> int:
        """Enqueue on the replica the router picks (default: least-loaded
        among routable replicas) and count the routed demand — the arrival
        signal the autoscaler's queueing model samples. Returns the chosen
        replica index (trace annotation)."""
        rs = self.replica_sets[mid]
        if self.router is not None:
            ri = self.router(rs, self.now)
        else:
            ri = min(rs.candidates(), key=lambda i: len(rs.queues[i]))
        if self.audit is not None:
            # decision-time evidence: the queue the router saw, plus the
            # router's own prediction when it exposes one (LECT's ect_s)
            ev = {"replica": ri, "queue_depth": len(rs.queues[ri]),
                  "free_in_s": max(rs.free_at[ri] - self.now, 0.0)}
            ev.update(getattr(self.router, "last_attrs", None) or {})
            self.audit.record(self.now, "router", "pick", model=mid,
                              evidence=ev)
        rs.queues[ri].put(q)
        self.metrics.inc(QUERIES_ROUTED, model=mid)
        return ri

    def _push(self, at: float, kind: str, payload) -> None:
        heapq.heappush(self._events, _Event(at, next(self._eseq), kind, payload))

    def replay(self, trace: Sequence[Tuple[float, Any, int]]) -> List[int]:
        """Open-loop replay of an arrival trace [(arrival_time, x, context_id)]
        — events are processed *between* arrivals so the virtual clock
        advances realistically. Returns query ids in order."""
        qids = []
        for at, x, ctx in trace:
            self.run(until=at)
            qids.append(self.submit(x, context_id=ctx, arrival_time=at))
        self.run()
        return qids

    # ------------------------------------------------------------------
    @property
    def pending(self) -> bool:
        """True while any event is scheduled or any query sits in a replica
        queue — the external drive predicate (the control-plane loop uses
        this, not the private event heap)."""
        if self._events:
            return True
        return any(len(queue) > 0 for rs in self.replica_sets.values()
                   for queue in rs.queues)

    @property
    def feedback_cache_hit_rate(self) -> float:
        tot = self._feedback_hits + self._feedback_misses
        return self._feedback_hits / tot if tot else 0.0

    # ------------------------------------------------------------------
    # fleet telemetry (repro.obs.timeseries, DESIGN.md §15)
    # ------------------------------------------------------------------
    def _rate(self, key: str, cur: float, dt: float) -> float:
        """Per-interval rate from a cumulative counter (probe state)."""
        prev = self._ts_prev.get(key, 0.0)
        self._ts_prev[key] = cur
        return (cur - prev) / dt

    def timeseries_probe(self, now: float, dt: float) -> Dict[str, float]:
        """FleetSampler probe: one flat gauge snapshot of the frontend's
        vital signs. Windowed rates (λ, cache hit rate, shed/degrade) are
        cumulative-counter deltas over the sample interval — the probe is
        stateful across samples but read-only on the run, so an observed
        run stays byte-identical to an unobserved one."""
        m = self.metrics
        out: Dict[str, float] = {
            "lambda": self._rate("lambda", m.counter(QUERIES_SUBMITTED), dt),
            "throughput": self._rate("done", m.counter(QUERIES_COMPLETED),
                                     dt),
            "admission.shed_rate": self._rate(
                "shed", m.counter(QUERIES_SHED), dt),
            "admission.degrade_rate": self._rate(
                "degraded", m.counter(QUERIES_DEGRADED), dt),
        }
        if self.cache is not None:
            hits, misses = m.counter(CACHE_HITS), m.counter(CACHE_MISSES)
            dh = hits - self._ts_prev.get("cache.hits", 0)
            dm = misses - self._ts_prev.get("cache.misses", 0)
            self._ts_prev["cache.hits"] = hits
            self._ts_prev["cache.misses"] = misses
            out["cache.occupancy"] = float(len(self.cache))
            out["cache.hit_rate"] = dh / (dh + dm) if (dh + dm) else 0.0
        for mid, rs in sorted(self.replica_sets.items()):
            backlog = sum(len(q) for i, q in enumerate(rs.queues)
                          if not rs.retired[i])
            inflight = sum(1 for i in range(len(rs.replicas))
                           if rs.free_at[i] > now and not rs.retired[i])
            budgets = [rs.queues[i].controller.max_batch_size
                       for i in rs.routable()]
            out[f"queue_depth.{mid}"] = float(backlog)
            out[f"inflight.{mid}"] = float(inflight)
            out[f"replicas_live.{mid}"] = float(rs.n_live)
            out[f"replicas_draining.{mid}"] = float(sum(rs.draining))
            out[f"replicas_failed.{mid}"] = float(
                sum(1 for r in rs.replicas if r.fail))
            out[f"replicas_suspected.{mid}"] = float(len(rs.suspected))
            out[f"est_service.{mid}"] = rs.mean_service()
            out[f"aimd_budget.{mid}"] = (
                sum(budgets) / len(budgets) if budgets else 0.0)
            out[f"lambda.{mid}"] = self._rate(
                f"routed.{mid}", m.counter(QUERIES_ROUTED, model=mid), dt)
        return out

    def report(self) -> Dict[str, Any]:
        """Canonical telemetry report (metrics.py schema, shared with
        LMServer). With a tracer attached the report gains the run-level
        ``latency_attribution`` (fractions of end-to-end latency per
        component, exact under a virtual clock) and a ``trace`` summary."""
        rep = self.metrics.report("frontend")
        dur = self.metrics.duration
        per_model = rep.get("per_model") or {}
        for mid, rs in sorted(self.replica_sets.items()):
            row = per_model.get(mid)
            if row is None:
                continue
            # busy-time / wall-time per replica: which copies actually
            # carried the load (capacity-planning evidence, DESIGN.md §15)
            row["replicas"] = [
                {"replica": st["replica"],
                 "busy_time": st["busy_time"],
                 "utilization": st["busy_time"] / dur if dur > 0 else 0.0,
                 "queries": st["queries"],
                 "retired": st["retired"]}
                for st in rs.replica_stats()]
        if self.tracer is not None:
            rep["latency_attribution"] = self.tracer.attribution_report()
            rep["trace"] = self.tracer.summary()
        return rep

    def report_json(self, **extra: Any) -> str:
        rep = self.report()
        rep.update(extra)
        return json.dumps(rep, sort_keys=True, indent=2)


def _default_loss(y, y_true) -> float:
    """0/1 loss on argmax for class scores; absolute error otherwise.

    Pipeline combine stages produce *structured* predictions — a
    ``{"y": scores, "confidence": ...}`` dict or a ``(scores, ...)`` tuple —
    which ``np.asarray`` would mangle (object arrays, ragged errors). Unwrap
    them to the payload first: dicts by their ``"y"`` key (else the first
    sorted key), tuples by their first element."""
    while isinstance(y, (dict, tuple)):
        if isinstance(y, dict):
            if not y:
                raise ValueError("empty dict prediction has no loss")
            y = y["y"] if "y" in y else y[sorted(y)[0]]
        else:
            if not y:
                raise ValueError("empty tuple prediction has no loss")
            y = y[0]
    y = np.asarray(y)
    if y.ndim >= 1 and y.size > 1:
        return float(np.argmax(y) != np.asarray(y_true))
    return float(min(1.0, abs(float(y) - float(y_true))))


def make_clipper(models: Dict[str, Callable], policy_kind: str = "exp4", *,
                 slo: float = 0.020, replicas: int = 1,
                 latency_models: Optional[Dict[str, Any]] = None,
                 batch_delay: float = 0.0, cache_size: int = 4096,
                 aimd_kwargs: Optional[dict] = None, device="cuda",
                 **kw) -> Clipper:
    """Convenience constructor: plain predict fns -> containers -> Clipper.
    The selection policy keeps its state on ``device`` (the card unless the
    caller asks for the CPU; raises without a card)."""
    aimd_kwargs = aimd_kwargs or {}
    sets = {}
    for mid, fn in models.items():
        lm = (latency_models or {}).get(mid)
        reps = [TorchModelContainer(mid, fn, latency_model=lm)
                for _ in range(replicas)]
        sets[mid] = ReplicaSet(
            reps, lambda: AIMDController(slo, **aimd_kwargs), batch_delay)
    ids = sorted(models)
    policy = (Exp3Policy(ids, device=device) if policy_kind == "exp3"
              else Exp4Policy(ids, device=device))
    return Clipper(sets, policy, slo=slo, cache_size=cache_size, **kw)
