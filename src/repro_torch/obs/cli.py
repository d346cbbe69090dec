"""Shared CLI wiring for the fleet-telemetry flags (DESIGN.md §15).

The three run CLIs (``repro.workloads.run``, ``repro.cluster.run``,
``repro.pipeline.run``) expose the same observability surface:

* ``--timeseries-out FILE``   — sample the fleet's vital signs at a fixed
  virtual-clock interval and write the ``repro.timeseries/v1`` document
  (with the SLO burn-rate monitor's alert events riding along);
* ``--timeseries-interval S`` — the sample interval (default: 0.05 s, the
  control tick);
* ``--audit-out FILE``        — record every control-plane decision
  (autoscaler grow/drain, admission shed/degrade, router pick, fault
  detect/recover/hedge/retry) with its decision-time evidence and write
  the ``repro.audit/v1`` document.

Both are off by default; when off, no sampler/audit object exists and
every instrumentation site in the stacks is a single ``is not None``
check — zero per-query overhead (the tracer's discipline).
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

DEFAULT_INTERVAL = 0.05


def add_fleet_args(p: argparse.ArgumentParser, *,
                   default_interval: float = DEFAULT_INTERVAL) -> None:
    """Add the ``--timeseries-out`` / ``--audit-out`` flag group."""
    p.add_argument("--timeseries-out", default=None,
                   help="sample fleet vital signs (repro.obs.timeseries) "
                        "and write the repro.timeseries/v1 document here — "
                        "byte-identical per seed; convert with "
                        "python -m repro.obs.export --mode timeseries")
    p.add_argument("--timeseries-interval", type=float,
                   default=default_interval,
                   help="sample interval in virtual seconds (default "
                        f"{default_interval:g}; only meaningful with "
                        "--timeseries-out)")
    p.add_argument("--audit-out", default=None,
                   help="record control-plane decisions with their "
                        "evidence (repro.obs.audit) and write the "
                        "repro.audit/v1 document here — convert with "
                        "python -m repro.obs.export --mode audit")


def build_fleet(args, parser: argparse.ArgumentParser
                ) -> Tuple[Optional[object], Optional[object]]:
    """(sampler, audit) from parsed args — (None, None) when both flags
    are off, so the run pays nothing for the capability."""
    sampler = None
    audit = None
    if args.timeseries_out:
        if args.timeseries_interval <= 0:
            parser.error("--timeseries-interval must be > 0")
        from repro_torch.obs import BurnRateMonitor, FleetSampler
        sampler = FleetSampler(interval=args.timeseries_interval,
                               monitor=BurnRateMonitor())
    if args.audit_out:
        from repro_torch.obs import AuditLog
        audit = AuditLog()
    return sampler, audit


def write_fleet(args, sampler, audit) -> None:
    """Serialize whichever collectors the flags enabled."""
    if args.timeseries_out and sampler is not None:
        with open(args.timeseries_out, "w") as f:
            f.write(sampler.to_json() + "\n")
    if args.audit_out and audit is not None:
        with open(args.audit_out, "w") as f:
            f.write(audit.to_json() + "\n")
