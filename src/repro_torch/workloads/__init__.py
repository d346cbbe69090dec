"""Workloads: open-loop arrival-trace generators (a copy of
``repro.workloads.traces``, numpy only). Deterministic from a seed: the
same call gives the same trace, byte for byte, in both packages."""

from repro_torch.workloads.traces import (bursty_trace, diurnal_trace,
                                          flash_crowd_trace, poisson_trace,
                                          query_trace)

__all__ = [
    "poisson_trace", "bursty_trace", "diurnal_trace", "flash_crowd_trace",
    "query_trace",
]
