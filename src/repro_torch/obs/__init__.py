"""Observability layer, counterpart of ``repro.obs`` (copies of its
modules): deterministic span tracing, fleet time-series telemetry, SLO
burn-rate alerting, and the control-plane decision audit log (DESIGN.md
§13/§15). The documents keep the reference's schema names, so the two
packages' documents compare byte for byte.

* ``Tracer`` / ``Span`` / ``SpanLog`` — clock-agnostic span recording with
  head-based seed-deterministic sampling and bounded memory
  (``repro.trace/v1``);
* ``FleetSampler`` / ``SeriesRing`` — interval sampling of the fleet's
  vital signs into bounded per-series rings (``repro.timeseries/v1``);
* ``BurnRateMonitor`` — multiwindow SLO burn-rate alerting with
  deterministic fire/resolve events;
* ``AuditLog`` — every autoscaler/admission/router/fault decision with
  its decision-time evidence (``repro.audit/v1``);
* ``python -m repro_torch.obs.export`` — Chrome ``trace_event`` (and CSV)
  conversion for flamegraph / counter-track inspection of any seeded run.
"""

from repro_torch.obs.audit import AUDIT_SCHEMA, AuditLog
from repro_torch.obs.monitor import BurnRateMonitor, MonitorConfig
from repro_torch.obs.timeseries import (TIMESERIES_SCHEMA, FleetSampler,
                                        SeriesRing)
from repro_torch.obs.tracer import (TRACE_SCHEMA, Span, SpanLog, Tracer,
                                    sample_decision)

__all__ = ["TRACE_SCHEMA", "TIMESERIES_SCHEMA", "AUDIT_SCHEMA",
           "Span", "SpanLog", "Tracer", "sample_decision",
           "FleetSampler", "SeriesRing", "BurnRateMonitor", "MonitorConfig",
           "AuditLog"]
