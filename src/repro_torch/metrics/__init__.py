"""Schema tooling for the shared report formats, counterpart of
``repro.metrics`` (copies of its modules).

The metrics *implementation* lives in ``repro_torch.core.metrics``
(re-exported here for convenience); this package adds the validation
surface:

    PYTHONPATH=src python -m repro_torch.metrics.validate report.json tr.json

validates ``repro.metrics/v1`` reports and ``repro.trace/v1`` span logs —
the check benches and CI use instead of ad-hoc key asserts.
"""

from repro_torch.core.metrics import (SCHEMA, MetricsRegistry,
                                      StreamingHistogram, VirtualClock)

# NOTE: repro_torch.metrics.validate is intentionally NOT imported here —
# eager import would trip runpy's double-import warning under
# ``python -m repro_torch.metrics.validate``. Import it explicitly.

__all__ = ["SCHEMA", "MetricsRegistry", "StreamingHistogram", "VirtualClock"]
