"""SLO-aware control plane (DESIGN.md §10), counterpart of
``repro.cluster``: the subsystem that closes the loop between the shared
telemetry (``core/metrics.py``) and serving capacity.

* ``autoscaler`` — per-model reactive replica controller with hysteresis
  and a queueing-model target (InferLine-style);
* ``admission`` — early load shedding: reject-or-degrade queries whose
  deadline is already unmeetable given the backlog;
* ``router``    — heterogeneity-aware routing by least expected completion
  time instead of queue length;
* ``plan``      — ``ClusterPlan`` + the deterministic tick-driven loop
  (``python -m repro_torch.cluster.run``) that replays any workload trace
  through either serving stack with the control plane active, emitting
  byte-identical ``repro.metrics/v1`` reports per seed (and the
  reference's report for the same seed).
"""

from repro_torch.cluster.admission import SloAdmission, expected_delay
from repro_torch.cluster.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.cluster.plan import (CLUSTER_DEFAULTS, ClusterPlan,
                                      cluster_scenario, replica_factory,
                                      run_plan, run_plan_json)
from repro_torch.cluster.router import (LeastExpectedCompletion, least_loaded,
                                        make_router)

__all__ = [
    "SloAdmission", "expected_delay",
    "Autoscaler", "AutoscalerConfig",
    "CLUSTER_DEFAULTS", "ClusterPlan", "cluster_scenario", "replica_factory",
    "run_plan", "run_plan_json",
    "LeastExpectedCompletion", "least_loaded", "make_router",
]
