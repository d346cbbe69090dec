"""PipelineExecutor: serve DAG pipelines on the event-driven Clipper
frontend (DESIGN.md §12). Counterpart of ``repro.pipeline.executor``: a
copy on ``TorchModelContainer``, whose Exp4 selection state lives on the
executor's ``device`` (the card unless the caller asks for the CPU), as
``make_clipper(device=)`` keeps the frontend's.

Each pipeline query walks the graph stage by stage. A stage becomes ready
when every parent has resolved; its gate (if any) may skip it outright
(cascade short-circuit), otherwise its models are submitted as one *stage
job* through ``Clipper.submit_stage`` — which means every existing layer
applies per stage:

* the **prediction cache** doubles as the pipeline's intermediate-result
  cache: stage inputs are digested like any query, so a shared prefix
  (same model, same stage input) is computed once across queries *and*
  across pipelines — the dataflow-caching effect (Sreekanti et al.);
* **admission control** sees per-stage deadlines carved from the pipeline
  SLO by the planner (``SloSplit.prefix``), so a stage whose share is
  already unmeetable sheds early instead of poisoning downstream stages;
* **adaptive batching** per stage model runs against the stage's *share*
  of the SLO (``SloSplit.shares`` feeds each AIMD controller), not the
  whole budget;
* **straggler mitigation** fires per stage: at the stage deadline the
  combine runs with whatever ensemble members arrived.

Completion, latency, and SLO attainment are accounted at *pipeline*
granularity in the shared ``repro.metrics/v1`` schema — a pipeline query
counts once no matter how many stage jobs it fanned into.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import metrics as M
from repro_torch.core.batching import AIMDController
from repro_torch.core.containers import ReplicaSet, TorchModelContainer
from repro_torch.core.frontend import Clipper
from repro_torch.core.interfaces import Prediction
from repro_torch.core.selection import Exp4Policy
from repro_torch.core.straggler import record_stragglers
from repro_torch.pipeline.graph import PipelineGraph, Stage
from repro_torch.pipeline.planner import SloSplit, split_slo, stage_estimates


class PipelineExecutor:
    """Drives one ``PipelineGraph`` over Clipper's event loop."""

    def __init__(self, graph: PipelineGraph, models: Dict[str, Callable], *,
                 slo: float = 0.020, latency_models: Optional[Dict] = None,
                 replicas: int = 1, batch_delay: float = 0.0,
                 cache_size: int = 4096, use_cache: bool = True,
                 seed: int = 0, admission=None, router=None,
                 metrics=None, service_priors: Optional[Dict[str, float]] = None,
                 replan_every: int = 64, aimd_kwargs: Optional[dict] = None,
                 tracer=None, audit=None, device="cuda"):
        self.graph = graph
        self.slo = slo
        # span tracing (repro_torch.obs, DESIGN.md §13): the tracer is
        # shared with the underlying Clipper, so stage jobs' queue/service
        # spans nest under the stage spans opened here
        self.tracer = tracer
        self.replan_every = replan_every
        missing = [m for m in graph.model_ids() if m not in models]
        if missing:
            raise ValueError(f"graph references unknown models {missing}")
        # initial split from priors (or the uniform fallback); each stage
        # model's AIMD controller gets the *stage's* latency budget
        priors = {n: max((service_priors or {}).get(mid, 0.0)
                         for mid in graph.stages[n].model_ids or ("",))
                  for n in graph.order}
        self.split: SloSplit = split_slo(graph, slo, priors)
        self.stage_of: Dict[str, str] = {}
        for n in graph.order:
            for mid in graph.stages[n].model_ids:
                self.stage_of.setdefault(mid, n)
        aimd_kwargs = aimd_kwargs or {}
        sets: Dict[str, ReplicaSet] = {}
        for mid in graph.model_ids():
            lm = (latency_models or {}).get(mid)
            reps = [TorchModelContainer(mid, models[mid], latency_model=lm)
                    for _ in range(replicas)]
            # the factory reads the *live* split, so replicas the autoscaler
            # adds mid-run batch against the current stage share, not the
            # prior-based share frozen at construction
            sets[mid] = ReplicaSet(
                reps,
                (lambda mid=mid: AIMDController(
                    self.split.shares[self.stage_of[mid]], **aimd_kwargs)),
                batch_delay)
        self.clip = Clipper(sets, Exp4Policy(sorted(sets), device=device),
                            slo=slo, cache_size=cache_size,
                            use_cache=use_cache, seed=seed, metrics=metrics,
                            router=router, admission=admission,
                            tracer=tracer, audit=audit)
        self.metrics = self.clip.metrics
        self._pseq = itertools.count()
        self._inflight: Dict[int, dict] = {}
        self.results: Dict[int, Prediction] = {}
        self.shed_qids: set = set()
        self._since_replan = 0
        self.replans = 0

    # ------------------------------------------------------------------
    # application API
    # ------------------------------------------------------------------
    def submit(self, x, *, arrival_time: Optional[float] = None) -> int:
        """Issue one pipeline query; returns the pipeline query id."""
        at = self.clip.now if arrival_time is None else arrival_time
        self.clip.now = max(self.clip.now, at)
        self._since_replan += 1
        if self._since_replan >= self.replan_every:
            self.replan()
        pid = next(self._pseq)
        self.metrics.inc(M.QUERIES_SUBMITTED)
        self.metrics.mark(at)
        trace = None
        if self.tracer is not None:
            # root span: the whole pipeline walk; budget = the full SLO
            trace = self.tracer.start_trace(
                "pipeline", "pipeline", at, budget_s=self.slo,
                attrs={"pid": pid})
        entry = {"x": x, "arrival": at, "outputs": {}, "done_stages": set(),
                 "launched": set(), "prefix": dict(self.split.prefix),
                 "done": False, "trace": trace,
                 "stage_spans": {}, "stage_times": {}}
        self._inflight[pid] = entry
        for stage in self.graph.roots():
            entry["launched"].add(stage.name)
            self._launch_stage(pid, stage)
        return pid

    def run(self, until: Optional[float] = None) -> None:
        self.clip.run(until=until)

    def replay(self, trace: Sequence[Tuple[float, Any, int]]) -> List[int]:
        """Open-loop replay of ``[(arrival_time, x, context_id)]`` — the
        same contract as ``Clipper.replay``."""
        pids = []
        for at, x, _ctx in trace:
            self.run(until=at)
            pids.append(self.submit(x, arrival_time=at))
        self.run()
        return pids

    @property
    def now(self) -> float:
        return self.clip.now

    @property
    def pending(self) -> bool:
        return self.clip.pending

    @property
    def replica_sets(self) -> Dict[str, ReplicaSet]:
        return self.clip.replica_sets

    def timeseries_probe(self, now: float, dt: float) -> Dict[str, float]:
        """FleetSampler probe: the underlying frontend's fleet series plus
        pipeline-level state — in-flight pipeline walks and the planner's
        live per-stage SLO shares (repro_torch.obs.timeseries, DESIGN.md
        §15)."""
        out = self.clip.timeseries_probe(now, dt)
        out["pipeline.inflight"] = float(len(self._inflight))
        for name, share in sorted(self.split.shares.items()):
            out[f"pipeline.slo_share.{name}"] = share
        return out

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def replan(self) -> SloSplit:
        """Recompute the SLO split from live service stats and point every
        stage's AIMD controllers at their new share. In-flight queries keep
        the prefix they were admitted under (their stage deadlines already
        exist as events); new queries use the new split. Deterministic: a
        pure function of the run so far."""
        self._since_replan = 0
        est = stage_estimates(self.graph, self.clip.replica_sets)
        self.split = split_slo(self.graph, self.slo, est)
        for mid, rs in self.clip.replica_sets.items():
            share = self.split.shares[self.stage_of[mid]]
            for queue in rs.queues:
                queue.controller.slo = share
        self.replans += 1
        return self.split

    # ------------------------------------------------------------------
    # stage machinery
    # ------------------------------------------------------------------
    def _launch_stage(self, pid: int, stage: Stage) -> None:
        entry = self._inflight[pid]
        # stage clock-in: launches are synchronous at the last parent's
        # resolution, so chained (start, end) pairs tile the pipeline's
        # critical path exactly — the attribution walk relies on this
        if entry.get("trace") is not None:
            entry["stage_times"][stage.name] = self.clip.now
        outs = {p: entry["outputs"][p] for p in stage.parents}
        if stage.gate is not None:
            if not stage.gate(outs):
                self.metrics.inc(M.PIPELINE_STAGES_SKIPPED)
                if entry.get("trace") is not None:
                    self.tracer.event(entry["trace"], f"skip:{stage.name}",
                                      "pipeline.gate", self.clip.now)
                self._stage_done(pid, stage, None)
                return
            self.metrics.inc(M.PIPELINE_ESCALATIONS)
            if entry.get("trace") is not None:
                self.tracer.event(entry["trace"], f"escalate:{stage.name}",
                                  "pipeline.gate", self.clip.now)
        xin = stage.prepare_input(entry["x"], outs)
        if not stage.model_ids:
            # pure combine node: resolves synchronously, costs nothing
            self._stage_done(pid, stage,
                             stage.combine_preds(xin, {}, outs))
            return
        self.metrics.inc(M.PIPELINE_STAGE_JOBS)
        deadline = entry["arrival"] + entry["prefix"][stage.name]
        span = None
        if entry.get("trace") is not None:
            # stage span budget: this stage's slice of the prefix deadlines
            # the query was admitted under (the planner's share at submit)
            budget = entry["prefix"][stage.name] - max(
                [entry["prefix"].get(p, 0.0) for p in stage.parents]
                or [0.0])
            span = self.tracer.start_span(
                entry["trace"], stage.name, "pipeline.stage", self.clip.now,
                budget_s=budget, attrs={"models": list(stage.model_ids)})
            entry["stage_spans"][stage.name] = span

        def finalize(preds, missing, at_deadline,
                     pid=pid, stage=stage, xin=xin, outs=outs):
            record_stragglers(self.metrics, missing)
            if not preds and missing:
                # every model of the stage was lost (crashed replicas,
                # exhausted retries — DESIGN.md §14): the pipeline degrades
                # to a shed downstream, but the fault is accounted here
                self.metrics.inc(M.PIPELINE_STAGES_FAILED)
            y = (stage.combine_preds(xin, preds, outs) if preds else None)
            self._stage_done(pid, stage, y)

        self.clip.submit_stage(stage.model_ids, xin, deadline=deadline,
                               finalize=finalize, trace_parent=span)

    def _stage_done(self, pid: int, stage: Stage, y: Any) -> None:
        entry = self._inflight[pid]
        if entry.get("trace") is not None:
            start = entry["stage_times"].get(stage.name, self.clip.now)
            entry["stage_times"][stage.name] = (start, self.clip.now)
            span = entry["stage_spans"].pop(stage.name, None)
            if span is not None:
                self.tracer.end_span(span, self.clip.now, empty=y is None)
        entry["outputs"][stage.name] = y
        entry["done_stages"].add(stage.name)
        if stage.name == self.graph.output:
            self._complete(pid, y)
            return
        for child in self.graph.children(stage.name):
            if (child.name not in entry["launched"]
                    and all(p in entry["done_stages"]
                            for p in child.parents)):
                entry["launched"].add(child.name)
                self._launch_stage(pid, child)

    def _complete(self, pid: int, y: Any) -> None:
        entry = self._inflight.pop(pid)
        entry["done"] = True
        if y is None:
            # every tier shed or straggled away: the pipeline has no answer
            self.metrics.inc(M.QUERIES_SHED)
            self.shed_qids.add(pid)
            if entry.get("trace") is not None:
                self.tracer.end_trace(entry["trace"], self.clip.now,
                                      status="shed")
            return
        latency = self.clip.now - entry["arrival"]
        if entry.get("trace") is not None:
            self._end_pipeline_trace(entry, latency)
        self.metrics.mark(self.clip.now)
        self.metrics.inc(M.QUERIES_COMPLETED)
        self.metrics.observe_latency(latency)
        conf = float(y.get("confidence", 1.0)) if isinstance(y, dict) else 1.0
        self.results[pid] = Prediction(pid, y, conf, latency=latency)

    def _end_pipeline_trace(self, entry: dict, latency: float) -> None:
        """Exact latency attribution (DESIGN.md §13): walk the critical
        path backwards from the output stage, at each step following the
        parent that resolved last. Stage launches are synchronous at the
        last parent's resolution, so the chained stage durations partition
        ``latency`` exactly — one ``pipeline.stage.<name>`` component per
        critical stage, fractions summing to 1."""
        attribution = None
        if latency > 0:
            times = entry["stage_times"]
            attribution = {}
            name = self.graph.output
            while name is not None:
                start, end = times[name]
                comp = f"pipeline.stage.{name}"
                attribution[comp] = attribution.get(comp, 0.0) + (end - start)
                parents = [p for p in self.graph.stages[name].parents
                           if isinstance(times.get(p), tuple)]
                name = (max(parents, key=lambda p: (times[p][1], p))
                        if parents else None)
        self.tracer.end_trace(entry["trace"], self.clip.now,
                              attribution=attribution)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """Shared-schema report plus a ``pipeline`` section (graph shape,
        live SLO split, stage-job accounting); with a tracer attached it
        also gains ``latency_attribution`` and a ``trace`` summary (same
        contract as ``Clipper.report``)."""
        rep = self.metrics.report("pipeline")
        dur = self.metrics.duration
        per_model = rep.get("per_model") or {}
        for mid, rs in sorted(self.replica_sets.items()):
            row = per_model.get(mid)
            if row is None:
                continue
            # per-replica busy-time / wall-time, as in Clipper.report
            row["replicas"] = [
                {"replica": st["replica"],
                 "busy_time": st["busy_time"],
                 "utilization": st["busy_time"] / dur if dur > 0 else 0.0,
                 "queries": st["queries"],
                 "retired": st["retired"]}
                for st in rs.replica_stats()]
        jobs = self.metrics.counter(M.PIPELINE_STAGE_JOBS)
        skipped = self.metrics.counter(M.PIPELINE_STAGES_SKIPPED)
        escalated = self.metrics.counter(M.PIPELINE_ESCALATIONS)
        gated = skipped + escalated
        rep["pipeline"] = {
            "graph": self.graph.describe(),
            "slo_split": self.split.describe(),
            "replans": self.replans,
            "stage_jobs": jobs,
            "stages_skipped": skipped,
            "escalations": escalated,
            "escalation_rate": (escalated / gated) if gated else 0.0,
            # stage-level admission actions (``admission.shed/degraded``
            # stay pipeline-granular: one per query)
            "stages_shed": self.metrics.counter(M.PIPELINE_STAGES_SHED),
            "stages_degraded": self.metrics.counter(
                M.PIPELINE_STAGES_DEGRADED),
            "stages_failed": self.metrics.counter(
                M.PIPELINE_STAGES_FAILED),
        }
        if self.tracer is not None:
            rep["latency_attribution"] = self.tracer.attribution_report()
            rep["trace"] = self.tracer.summary()
        return rep

    def report_json(self, **extra: Any) -> str:
        import json
        rep = self.report()
        rep.update(extra)
        return json.dumps(rep, sort_keys=True, indent=2)
