"""Per-stage SLO splitting for prediction pipelines (DESIGN.md §12);
counterpart of ``repro.pipeline.planner`` (a copy).

InferLine's observation: a pipeline served under one end-to-end SLO needs
that SLO *divided* across stages, so each stage's admission control and
adaptive batching optimize against the share it actually has — not the whole
budget. The splitter here is the deterministic proportional rule:

    share(s)   = slo * est(s) / critical_path
    prefix(s)  = slo * longest_path_through(s) / critical_path

where ``est(s)`` is the stage's expected service time (max over its models'
observed per-query service, fan-out within a stage runs in parallel) and
``critical_path`` is the longest root-to-leaf path by ``est``. Properties
(tested in tests/test_pipeline.py):

* along any root-to-leaf path the shares sum to <= slo (the critical path
  sums to exactly slo);
* share(s) is monotone non-decreasing in est(s);
* prefix(output) == slo, so the pipeline deadline is exactly the query SLO.

The executor feeds ``prefix(s)`` into stage deadlines (admission control
slack) and ``share(s)`` into each stage's AIMD latency budget, and replans
periodically from live ``ReplicaSet`` stats as service estimates converge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

from repro_torch.pipeline.graph import PipelineGraph

# floor for a stage's service estimate: keeps the split defined before any
# stats exist (all-equal estimates -> equal split by critical-path depth)
MIN_EST = 1e-6


@dataclass(frozen=True)
class SloSplit:
    """One deterministic division of a pipeline SLO across stages."""

    slo: float
    shares: Dict[str, float]       # per-stage latency budget
    prefix: Dict[str, float]       # absolute offset of the stage's deadline
    critical_path_s: float         # longest path by service estimate

    def describe(self) -> Dict[str, object]:
        return {
            "slo": self.slo,
            "critical_path_s": self.critical_path_s,
            "shares": {k: self.shares[k] for k in sorted(self.shares)},
            "prefix": {k: self.prefix[k] for k in sorted(self.prefix)},
        }


def stage_estimates(graph: PipelineGraph, replica_sets: Mapping[str, object],
                    default: float = 1e-3) -> Dict[str, float]:
    """Expected service seconds per stage from live per-replica stats: the
    max over the stage's models of ``ReplicaSet.mean_service`` (fan-out
    within a stage evaluates in parallel, so the slowest member binds).
    Pure combine stages cost nothing (MIN_EST)."""
    out: Dict[str, float] = {}
    for name in graph.order:
        stage = graph.stages[name]
        ests = [replica_sets[mid].mean_service(default)
                for mid in stage.model_ids if mid in replica_sets]
        out[name] = max([e for e in ests if e > 0.0] or [MIN_EST])
    return out


def split_slo(graph: PipelineGraph, slo: float,
              est: Optional[Mapping[str, float]] = None) -> SloSplit:
    """Divide ``slo`` across the graph's stages proportionally to service
    estimates along the critical path (module docstring)."""
    assert slo > 0.0
    e = {n: max(float((est or {}).get(n, MIN_EST)), MIN_EST)
         for n in graph.order}
    finish: Dict[str, float] = {}
    for n in graph.order:               # topo order: parents precede children
        start = max((finish[p] for p in graph.stages[n].parents), default=0.0)
        finish[n] = start + e[n]
    critical = max(finish.values())
    shares = {n: slo * e[n] / critical for n in graph.order}
    prefix = {n: slo * finish[n] / critical for n in graph.order}
    # the output stage's deadline is the query deadline even when it is not
    # on the critical path (every path must resolve by the pipeline SLO)
    prefix[graph.output] = slo
    return SloSplit(slo=slo, shares=shares, prefix=prefix,
                    critical_path_s=critical)
