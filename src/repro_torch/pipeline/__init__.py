"""Prediction pipelines (DESIGN.md §12), counterpart of ``repro.pipeline``:
DAG composition of model containers and LM engines, served end-to-end
under one SLO.

* ``graph``    — ``PipelineGraph`` / ``Stage`` spec with fan-out, fan-in,
  and gated (cascade) stages; canonical builders ``cascade_graph`` and
  ``fanout_graph``;
* ``planner``  — InferLine-style per-stage SLO splitting from observed
  service stats (``split_slo``), feeding stage deadlines into admission
  control and stage shares into the AIMD batching controllers;
* ``executor`` — ``PipelineExecutor`` on the event-driven Clipper frontend,
  with the prediction cache reused as the intermediate-result cache;
* ``cascade``  — ``LMCascade``: draft-then-verify across two LM engines;
* ``scenario`` / ``run`` — named pipeline presets and the deterministic
  ``python -m repro_torch.pipeline.run`` CLI (byte-identical reports per
  seed, and the reference's report for the same seed).
"""

from repro_torch.pipeline.cascade import (LMCascade, distinct_token_confidence,
                                          make_escalate)
from repro_torch.pipeline.executor import PipelineExecutor
from repro_torch.pipeline.graph import (PipelineGraph, Stage,
                                        agreement_combine, cascade_graph,
                                        fanout_graph)
from repro_torch.pipeline.planner import (MIN_EST, SloSplit, split_slo,
                                          stage_estimates)
from repro_torch.pipeline.scenario import (CASCADE_THRESHOLD, build_executor,
                                           build_graph, pipeline_models,
                                           pipeline_replica_factory,
                                           pipeline_scenario, run_lmcascade,
                                           run_pipeline)

__all__ = [
    "LMCascade", "distinct_token_confidence", "make_escalate",
    "PipelineExecutor",
    "PipelineGraph", "Stage", "agreement_combine", "cascade_graph",
    "fanout_graph",
    "MIN_EST", "SloSplit", "split_slo", "stage_estimates",
    "CASCADE_THRESHOLD", "build_executor", "build_graph", "pipeline_models",
    "pipeline_replica_factory", "pipeline_scenario", "run_lmcascade",
    "run_pipeline",
]
