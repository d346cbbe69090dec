"""Workload scenarios, counterpart of ``repro.workloads``: open-loop
arrival-trace generators (copies of the reference's, byte for byte) plus a
``ScenarioRunner`` that replays a trace through either serving stack
(discrete-event ``Clipper`` frontend or continuous-batching ``LMServer``)
and emits the shared ``repro.metrics/v1`` report.

Everything is deterministic from a seed — the same scenario run twice
produces byte-identical reports — which is what makes tail latency, SLO
attainment, and batch-size adaptation exact test oracles (paper Figs 4/6/9
methodology; DESIGN.md §9).
"""

from repro_torch.workloads.scenario import (SCENARIOS, Scenario,
                                            ScenarioRunner, frontend_models,
                                            run_scenario, trace_meta)
from repro_torch.workloads.traces import (bursty_trace, diurnal_trace,
                                          flash_crowd_trace, poisson_trace,
                                          query_trace)

__all__ = [
    "SCENARIOS", "Scenario", "ScenarioRunner", "run_scenario",
    "frontend_models", "trace_meta",
    "poisson_trace", "bursty_trace", "diurnal_trace", "flash_crowd_trace",
    "query_trace",
]
