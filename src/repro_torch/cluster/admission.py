"""SLO-aware admission control: early load shedding (DESIGN.md §10);
counterpart of ``repro.cluster.admission`` (a copy).

Clipper's straggler mitigation (paper §5.2.2) salvages queries *after* they
blow the deadline; admission control refuses work whose deadline is already
unmeetable *before* it joins a queue, so overload degrades into explicit
sheds instead of a collapse of every in-flight query's latency (the
InferLine observation). The expected delay for a query is estimated from
current backlog and the per-replica service stats the control plane already
tracks:

    delay(model) = min over routable replicas i of
                   max(free_at[i] - now, 0) + (backlog_i + 1) * E[service_i]

Two policies:

* ``shed``    — reject the query outright when *no* chosen model can meet
                its deadline (and nothing is cached);
* ``degrade`` — first narrow the ensemble to the models that can meet the
                deadline (counted as ``queries.degraded``), shedding only
                when none remain.

Shed and degraded queries are reported through the shared telemetry schema
(``admission.shed`` / ``admission.degraded``), and sheds count against SLO
attainment — the controller cannot game the metric by rejecting everything.

``LMAdmission`` applies the same idea in front of the continuous-batching
``LMServer``: expected wait is the queued backlog spread over the decode
slots at the observed engine-seconds per request.
"""

from __future__ import annotations

from typing import List, Sequence

from repro_torch.core import metrics as M
from repro_torch.core.containers import ReplicaSet
from repro_torch.core.interfaces import Query

POLICIES = ("shed", "degrade")


def expected_delay(rs: ReplicaSet, now: float,
                   default_service: float = 0.0) -> float:
    """Expected queueing + service delay for a query enqueued now — the
    best (earliest) expected completion across routable replicas."""
    # deliberately narrower than ReplicaSet.candidates(): when every replica
    # has failed (statically, or marked down by the failure detector —
    # DESIGN.md §14), the expected delay is infinite and a finite margin
    # never admits — the query sheds rather than being estimated against
    # the dead fallback slot candidates() would still enqueue on
    cands = rs.routable() or rs.healthy()
    if not cands:
        return float("inf")
    return min(rs.expected_completion(i, now, default_service)
               for i in cands)


class SloAdmission:
    """Admission controller for the Clipper frontend (and, via ``admit_lm``,
    the LMServer). ``margin`` scales the delay estimate: > 1 sheds earlier
    (more headroom), < 1 gambles on the estimate being pessimistic."""

    def __init__(self, *, policy: str = "degrade", margin: float = 1.0,
                 default_service: float = 0.0):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}: {policy!r}")
        self.policy = policy
        self.margin = margin
        self.default_service = default_service

    # -- frontend hook (Clipper.submit / submit_stage) ------------------
    def admit(self, clip, q: Query, chosen: Sequence[str], *,
              cached: bool = False,
              shed_counter: str = M.QUERIES_SHED,
              degraded_counter: str = M.QUERIES_DEGRADED,
              trace_parent=None) -> List[str]:
        """Return the subset of ``chosen`` to actually enqueue. Empty with
        ``cached=False`` means the query is shed (counted here); empty with
        ``cached=True`` degrades to a cache-only answer.

        ``shed_counter`` / ``degraded_counter`` name the series the
        decision is recorded under — pipeline stage jobs pass stage-scoped
        names so ``admission.shed/degraded`` stay one-per-pipeline-query.
        ``trace_parent``: when the query carries a sampled trace
        (repro_torch.obs), shed/degrade verdicts are recorded as instant
        events under it."""
        slack = (q.deadline - clip.now) if q.deadline is not None else None
        if slack is None:
            return list(chosen)
        delays = {
            mid: expected_delay(clip.replica_sets[mid], clip.now,
                                self.default_service)
            for mid in chosen
        }
        meetable = [mid for mid in chosen
                    if delays[mid] * self.margin <= slack]
        if self.policy == "shed":
            if meetable or cached:
                return list(chosen)
            clip.metrics.inc(shed_counter)
            self._explain(clip, trace_parent, "shed", slack, chosen, [],
                          delays, shed_counter)
            return []
        if not meetable:
            if cached:
                clip.metrics.inc(degraded_counter)
                self._explain(clip, trace_parent, "degrade", slack, chosen,
                              [], delays, degraded_counter)
                return []
            clip.metrics.inc(shed_counter)
            self._explain(clip, trace_parent, "shed", slack, chosen, [],
                          delays, shed_counter)
            return []
        if len(meetable) < len(chosen):
            clip.metrics.inc(degraded_counter)
            self._explain(clip, trace_parent, "degrade", slack, chosen,
                          meetable, delays, degraded_counter)
        return meetable

    def _explain(self, clip, parent, verdict: str, slack: float,
                 chosen: Sequence[str], kept: Sequence[str],
                 delays, counter: str) -> None:
        """Record the verdict: instant event on the query's trace (when
        sampled) and an audit record with the expected-delay evidence."""
        dropped = sorted(set(chosen) - set(kept))
        if parent is not None and getattr(clip, "tracer", None) is not None:
            clip.tracer.event(parent, verdict, "frontend.admission",
                              clip.now,
                              attrs={"slack_s": slack, "dropped": dropped})
        audit = getattr(clip, "audit", None)
        if audit is not None:
            audit.record(
                clip.now, "admission", verdict,
                evidence={"slack_s": slack, "margin": self.margin,
                          "expected_delay_s": dict(sorted(delays.items())),
                          "chosen": list(chosen), "kept": list(kept),
                          "counter": counter})

    # -- LMServer hook (engine.submit) ----------------------------------
    def admit_lm(self, srv, now: float) -> bool:
        """Admit unless the queued backlog alone is expected to eat the
        whole SLO before this request reaches a slot."""
        est = srv.est_request_service()
        if est <= 0.0:
            return True                    # no signal yet: admit
        backlog = len(srv._queue)
        wait = (backlog + 1) * est / max(srv.slots, 1)
        if wait * self.margin <= srv.slo:
            return True
        audit = getattr(srv, "audit", None)
        if audit is not None:
            audit.record(
                now, "admission", "shed", model=srv.model_id,
                evidence={"backlog": backlog, "est_service_s": est,
                          "expected_wait_s": wait, "slo_s": srv.slo,
                          "margin": self.margin, "slots": srv.slots})
        return False
