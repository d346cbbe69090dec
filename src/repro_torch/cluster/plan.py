"""ClusterPlan + the deterministic control loop (DESIGN.md §10).
Counterpart of ``repro.cluster.plan``: a copy whose plan names a
``device`` (the card unless the caller asks for the CPU) for the stacks'
selection state and the lmserver stack's LM. The device is not part of the
reported plan, so a card run's report equals a CPU run's and the
reference's.

A ``ClusterPlan`` bundles a workload ``Scenario`` with the control-plane
configuration — autoscaling, admission policy, routing strategy, and the
control tick. ``run_plan`` replays the scenario's arrival trace through the
chosen serving stack with the control plane active, invoking the autoscaler
at every tick boundary of the virtual clock, and emits the shared
``repro.metrics/v1`` report plus a ``cluster`` section (replica timeline,
scale events, per-replica stats). Everything is a pure function of the
plan, so the same plan run twice yields byte-identical JSON.

The cluster scenario defaults differ from the plain workload defaults:
one model, unique queries, and a heavier per-item cost (2 ms), so a single
replica saturates near 450 qps under the 20 ms SLO — the regime where a
flash crowd actually needs the control plane (paper Fig 6 territory).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cluster.admission import SloAdmission
from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.cluster.router import make_router
from repro_torch.faults import FaultPlan, RecoveryPolicy, attach_faults
from repro_torch.core import metrics as M
from repro_torch.core.containers import TorchModelContainer, linear_latency
from repro_torch.core.frontend import make_clipper
from repro_torch.workloads import traces as T
from repro_torch.workloads.scenario import (D_FEAT, SCENARIOS, Scenario,
                                            ScenarioRunner, frontend_models,
                                            trace_meta)

# Overrides applied by ``cluster_scenario`` on top of the named workload
# scenarios: the control-plane regime (single capacity-limited model).
CLUSTER_DEFAULTS: Dict[str, Any] = dict(
    ensemble=1, replicas=1, pool=0, per_item_latency=2e-3)


def cluster_scenario(name: str, **overrides: Any) -> Scenario:
    """A named workload scenario re-parameterized for control-plane runs."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return dataclasses.replace(SCENARIOS[name],
                               **{**CLUSTER_DEFAULTS, **overrides})


@dataclass(frozen=True)
class ClusterPlan:
    """One reproducible control-plane run."""

    scenario: Scenario
    stack: str = "frontend"         # frontend | lmserver | pipeline
    autoscale: bool = True          # frontend stack only
    admission: Optional[str] = None          # None | shed | degrade
    router: str = "lect"            # lect | least_loaded
    tick: float = 0.05              # control period (virtual seconds)
    utilization_cap: float = 0.7
    drain_target: Optional[float] = None     # None = the scenario SLO
    min_replicas: int = 1
    max_replicas: int = 8
    up_ticks: int = 1
    down_ticks: int = 4
    cooldown_ticks: int = 12        # quiescent ticks so scale-down settles
    admission_margin: float = 1.0
    # fault injection + recovery (repro_torch.faults, DESIGN.md §14): spec
    # strings attached to the scenario's replicas at build time, seeded by
    # the scenario seed. ``recovery`` arms the frontend's failure detector
    # + hedged retries; with faults but no recovery the run is the
    # collapse baseline bench_faults measures against.
    faults: Tuple[str, ...] = ()
    recovery: bool = True
    # where the selection state and the LM live (not reported)
    device: Any = "cuda"

    def autoscaler_config(self) -> AutoscalerConfig:
        return AutoscalerConfig(
            tick=self.tick, utilization_cap=self.utilization_cap,
            drain_target=self.drain_target, min_replicas=self.min_replicas,
            max_replicas=self.max_replicas, up_ticks=self.up_ticks,
            down_ticks=self.down_ticks)

    def describe(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        del d["scenario"]           # reported separately
        del d["device"]             # the same run on any device
        return d


def replica_factory(scenario: Scenario, models: Dict[str, Any]):
    """Deterministic supplier of fresh replicas for the autoscaler: replica
    k of model i draws its latency stream from seed (scenario.seed, i, k),
    so an autoscaled run is byte-identical across runs while every replica
    straggles independently."""
    ids = sorted(models)
    counters: Dict[str, int] = {}

    def make(mid: str) -> TorchModelContainer:
        k = counters.get(mid, 0)
        counters[mid] = k + 1
        i = ids.index(mid)
        lat = linear_latency(
            scenario.base_latency * (1.0 + 0.3 * i),
            scenario.per_item_latency,
            p_straggle=scenario.p_straggle,
            straggle_factor=scenario.straggle_factor,
            rng=np.random.default_rng([scenario.seed, 7000 + i, k]))
        return TorchModelContainer(mid, models[mid], latency_model=lat)

    return make


# ---------------------------------------------------------------------------
# control loops
# ---------------------------------------------------------------------------

def _drive_ticks(serve, submit, trace, autoscalers: List[Autoscaler],
                 plan: ClusterPlan, sampler=None) -> None:
    """Tick-driven replay shared by the frontend and pipeline stacks:
    arrivals are interleaved with event processing as in ``Clipper.replay``,
    but the clock is stepped in control periods and every autoscaler
    observes the world at each boundary. ``serve`` needs ``run`` / ``now``
    (settable) / ``pending``; ``submit(x, ctx, at)`` issues one query.
    ``sampler``: an optional ``repro_torch.obs.FleetSampler`` polled after
    the autoscalers so each sample sees the post-decision fleet state."""
    i, t, idle = 0, 0.0, 0
    while True:
        t += plan.tick
        while i < len(trace) and trace[i][0] <= t:
            at, x, ctx = trace[i]
            serve.run(until=at)
            submit(x, ctx, at)
            i += 1
        serve.run(until=t)
        if serve.now < t:
            # idle gap: advance the virtual clock so delayed batches and
            # drain checks see time passing, then dispatch what became ready
            serve.now = t
            serve.run(until=t)
        for a in autoscalers:
            a.tick(t)
        if sampler is not None:
            sampler.sample_until(t)
        if i >= len(trace) and not serve.pending:
            idle += 1
            # end only after the cooldown AND once every autoscaler has
            # drained back to its floor — a short trace that ends mid-burst
            # must still unwind its scale-ups (one retire per tick, so this
            # terminates within max_replicas extra ticks)
            if (idle > plan.cooldown_ticks
                    and all(a.rs.n_live <= a.cfg.min_replicas
                            for a in autoscalers)):
                break
        else:
            idle = 0


def _decisions_section(metrics, replica_sets, audit=None) -> Dict[str, Any]:
    """Control-plane decision tallies (DESIGN.md §15): grow/drain counts
    per model plus shed/degrade totals — derived from the shared counters,
    so the section is schema-stable whether or not an audit log was
    attached; with one attached its exact per-action counts ride along."""
    return {
        "per_model": {
            mid: {"grow": metrics.counter(M.REPLICAS_ADDED, model=mid),
                  "drain": metrics.counter(M.REPLICAS_RETIRED, model=mid)}
            for mid in sorted(replica_sets)},
        "shed": metrics.counter(M.QUERIES_SHED),
        "degraded": metrics.counter(M.QUERIES_DEGRADED),
        "audit": audit.summary() if audit is not None else None,
    }


def _cluster_section(plan: ClusterPlan, autoscalers: List[Autoscaler],
                     replica_sets, metrics=None,
                     audit=None) -> Dict[str, Any]:
    out = {
        "plan": plan.describe(),
        "autoscalers": [a.summary() for a in autoscalers],
        "replica_sets": {mid: {"live": rs.n_live,
                               "total_slots": len(rs.replicas),
                               "replicas": rs.replica_stats()}
                         for mid, rs in sorted(replica_sets.items())},
    }
    if metrics is not None:
        out["decisions"] = _decisions_section(metrics, replica_sets, audit)
    return out


def _apply_faults(plan: ClusterPlan, clip) -> None:
    """Attach the plan's fault specs to the stack's replica sets (seeded by
    the scenario seed) and arm recovery on the frontend event loop."""
    if plan.faults:
        attach_faults(clip.replica_sets,
                      FaultPlan.from_specs(plan.faults,
                                           seed=plan.scenario.seed))
    if plan.faults and plan.recovery:
        clip.recovery = RecoveryPolicy()


def _run_frontend(plan: ClusterPlan, tracer=None, sampler=None,
                  audit=None) -> Dict[str, Any]:
    s = plan.scenario
    models, lat = frontend_models(s)
    admission = (SloAdmission(policy=plan.admission,
                              margin=plan.admission_margin)
                 if plan.admission else None)
    clip = make_clipper(models, "exp4", slo=s.slo, replicas=s.replicas,
                        latency_models=lat, batch_delay=s.batch_delay,
                        seed=s.seed, router=make_router(plan.router),
                        admission=admission, tracer=tracer, audit=audit,
                        device=plan.device)
    _apply_faults(plan, clip)
    autoscalers: List[Autoscaler] = []
    if plan.autoscale:
        factory = replica_factory(s, models)
        cfg = plan.autoscaler_config()
        for mid in sorted(clip.replica_sets):
            autoscalers.append(Autoscaler(clip.replica_sets[mid], factory,
                                          clip.metrics, cfg, slo=s.slo,
                                          audit=audit))
    if sampler is not None:
        sampler.bind(metrics=clip.metrics, tracer=tracer)
        sampler.add_probe(clip.timeseries_probe)
    trace = T.query_trace(s.arrival_times(), s.seed, d_feat=D_FEAT,
                          pool=s.pool)
    _drive_ticks(clip, lambda x, ctx, at: clip.submit(
        x, context_id=ctx, arrival_time=at), trace, autoscalers, plan,
        sampler)
    rep = clip.report()
    rep["cluster"] = _cluster_section(plan, autoscalers, clip.replica_sets,
                                      clip.metrics, audit)
    return rep


def _run_pipeline(plan: ClusterPlan, tracer=None, sampler=None,
                  audit=None) -> Dict[str, Any]:
    """Pipeline stack with per-stage provisioning: every stage model gets
    its own autoscaler whose drain target is the *stage's* share of the
    pipeline SLO (planner split), so a hot verify tier grows independently
    of an idle draft tier."""
    from repro_torch.pipeline.scenario import (build_executor, pipeline_models,
                                               pipeline_replica_factory)

    s = plan.scenario
    admission = (SloAdmission(policy=plan.admission,
                              margin=plan.admission_margin)
                 if plan.admission else None)
    zoo = pipeline_models(s)        # one zoo: executor + replica factory
    ex = build_executor(s, "cascade", admission=admission,
                        router=make_router(plan.router), zoo=zoo,
                        tracer=tracer, audit=audit, device=plan.device)
    _apply_faults(plan, ex.clip)
    autoscalers: List[Autoscaler] = []
    if plan.autoscale:
        factory = pipeline_replica_factory(s, zoo[0])
        cfg = plan.autoscaler_config()
        for mid in sorted(ex.replica_sets):
            # callable: the drain target follows the planner's live replans
            # instead of freezing at the prior-based initial split
            stage_slo = (lambda mid=mid:
                         ex.split.shares[ex.stage_of[mid]])
            autoscalers.append(Autoscaler(ex.replica_sets[mid], factory,
                                          ex.metrics, cfg, slo=stage_slo,
                                          audit=audit))
    if sampler is not None:
        sampler.bind(metrics=ex.metrics, tracer=tracer)
        sampler.add_probe(ex.timeseries_probe)
    trace = T.query_trace(s.arrival_times(), s.seed, d_feat=D_FEAT,
                          pool=s.pool)
    _drive_ticks(ex.clip, lambda x, ctx, at: ex.submit(x, arrival_time=at),
                 trace, autoscalers, plan, sampler)
    rep = ex.report()
    rep["cluster"] = _cluster_section(plan, autoscalers, ex.replica_sets,
                                      ex.metrics, audit)
    return rep


def _run_lmserver(plan: ClusterPlan, tracer=None, sampler=None,
                  audit=None) -> Dict[str, Any]:
    s = plan.scenario
    if plan.faults:
        # replica-oriented fault specs have no target here: the LM stack
        # models faults per-request (serving.engine faults=RequestFaults)
        raise ValueError("fault plans apply to the frontend/pipeline "
                         "stacks; the lmserver stack takes "
                         "RequestFaults on the engine")
    admission = (SloAdmission(policy=plan.admission,
                              margin=plan.admission_margin)
                 if plan.admission else None)
    runner = ScenarioRunner(s, tracer=tracer, sampler=sampler, audit=audit,
                            device=plan.device)
    rep = runner.run_lmserver(admission=admission)
    rep["cluster"] = {"plan": plan.describe(), "autoscalers": [],
                      "replica_sets": {},
                      "decisions": {
                          "per_model": {},
                          "shed": rep["admission"]["shed"],
                          "degraded": rep["admission"]["degraded"],
                          "audit": (audit.summary()
                                    if audit is not None else None)}}
    return rep


def run_plan(plan: ClusterPlan, *, tracer=None, sampler=None,
             audit=None) -> Dict[str, Any]:
    """Execute the plan; returns the shared-schema report with the extra
    ``cluster`` section and trace provenance ``meta``. ``tracer``: an
    optional ``repro_torch.obs.Tracer`` threaded into the chosen stack;
    ``sampler`` / ``audit``: optional ``repro_torch.obs`` FleetSampler /
    AuditLog, attached the same way (off by default, no hot-path cost).
    The stack runs on ``plan.device``."""
    if plan.stack == "frontend":
        rep = _run_frontend(plan, tracer, sampler, audit)
    elif plan.stack == "lmserver":
        rep = _run_lmserver(plan, tracer, sampler, audit)
    elif plan.stack == "pipeline":
        rep = _run_pipeline(plan, tracer, sampler, audit)
    else:
        raise ValueError(f"unknown stack: {plan.stack}")
    rep["scenario"] = dataclasses.asdict(plan.scenario)
    rep["meta"] = trace_meta(plan.scenario)
    return rep


def run_plan_json(plan: ClusterPlan, *, tracer=None, sampler=None,
                  audit=None) -> str:
    """Stable JSON rendering — byte-identical for identical plans."""
    return json.dumps(run_plan(plan, tracer=tracer, sampler=sampler,
                               audit=audit), sort_keys=True, indent=2)
