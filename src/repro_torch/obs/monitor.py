"""SLO burn-rate monitor: multiwindow alerting over windowed attainment
(DESIGN.md §15).

The classic SRE recipe adapted to the serving fleet: the *error budget* is
``1 - objective`` (objective = the target SLO attainment, e.g. 0.95), the
windowed *error rate* is the fraction of finished queries in the window
that blew their deadline or were shed, and the *burn rate* is error rate
over budget — burn 1.0 consumes the budget exactly at quota. An alert
fires only when **both** a fast and a slow window burn above the
threshold: the fast window gives quick detection and quick resolution, the
slow window suppresses one-batch blips. Fire and resolve are deterministic
events on the sampler's tick boundaries — a pure function of the seeded
run, recorded in the ``repro.timeseries/v1`` document (and mirrored into
the span log as ``alert.fire`` / ``alert.resolve`` global events when
tracing is on).

The monitor is read-only: it samples the stack's ``MetricsRegistry``
counters (completed / violations / shed) and never mutates them, so an
observed run stays byte-identical to an unobserved one.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import metrics as M


@dataclass(frozen=True)
class MonitorConfig:
    objective: float = 0.95         # target SLO attainment
    fast_window: float = 0.25       # quick detect / quick resolve (s)
    slow_window: float = 0.75       # blip suppression (s)
    burn_threshold: float = 2.0     # fire when both windows burn above this

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


class BurnRateMonitor:
    """Multiwindow burn-rate alerting for one serving stack.

    ``observe(now)`` snapshots the counters, computes both windowed burn
    rates, steps the fire/resolve state machine, and returns the alert
    transitions (usually none). The latest gauges are left in ``gauges``
    for the sampler to record as series."""

    def __init__(self, cfg: Optional[MonitorConfig] = None, *,
                 name: str = "slo_burn"):
        self.cfg = cfg if cfg is not None else MonitorConfig()
        self.name = name
        self.metrics = None
        # (t, completed, violations, shed) — windowed deltas read off this
        self._snaps: deque = deque()
        self.active = False
        self.fired = 0
        self.resolved = 0
        self.gauges: Dict[str, float] = {}

    def bind(self, metrics) -> None:
        self.metrics = metrics

    # ------------------------------------------------------------------
    def _window_error(self, now: float, window: float) -> float:
        """Error rate over the trailing window: (violations + sheds) /
        (finished + sheds), from the newest snapshot at or before
        ``now - window`` (or the oldest available early in the run)."""
        newest = self._snaps[-1]
        base = self._snaps[0]
        cutoff = now - window
        for snap in self._snaps:
            if snap[0] <= cutoff + 1e-12:
                base = snap
            else:
                break
        d_done = newest[1] - base[1]
        d_viol = newest[2] - base[2]
        d_shed = newest[3] - base[3]
        finished = d_done + d_shed
        if finished <= 0:
            return 0.0
        return (d_viol + d_shed) / finished

    def observe(self, now: float) -> List[Dict[str, Any]]:
        """One monitoring step at ``now``; returns fire/resolve events."""
        if self.metrics is None:
            return []
        cfg = self.cfg
        m = self.metrics
        self._snaps.append((now, m.counter(M.QUERIES_COMPLETED),
                            m.counter(M.SLO_VIOLATIONS),
                            m.counter(M.QUERIES_SHED)))
        # keep one snapshot beyond the slow window so the windowed delta
        # always has a base point
        while (len(self._snaps) > 2
               and self._snaps[1][0] <= now - cfg.slow_window - 1e-12):
            self._snaps.popleft()
        err_fast = self._window_error(now, cfg.fast_window)
        err_slow = self._window_error(now, cfg.slow_window)
        burn_fast = err_fast / cfg.budget
        burn_slow = err_slow / cfg.budget
        events: List[Dict[str, Any]] = []
        evidence = {
            "burn_fast": burn_fast, "burn_slow": burn_slow,
            "error_fast": err_fast, "error_slow": err_slow,
            "threshold": cfg.burn_threshold, "budget": cfg.budget,
            "fast_window_s": cfg.fast_window,
            "slow_window_s": cfg.slow_window,
        }
        if (not self.active and burn_fast > cfg.burn_threshold
                and burn_slow > cfg.burn_threshold):
            self.active = True
            self.fired += 1
            events.append({"t": now, "kind": "fire", "alert": self.name,
                           "evidence": evidence})
        elif (self.active and burn_fast <= cfg.burn_threshold
                and burn_slow <= cfg.burn_threshold):
            self.active = False
            self.resolved += 1
            events.append({"t": now, "kind": "resolve", "alert": self.name,
                           "evidence": evidence})
        self.gauges = {
            "slo.attainment_fast": 1.0 - err_fast,
            "slo.attainment_slow": 1.0 - err_slow,
            "slo.burn_fast": burn_fast,
            "slo.burn_slow": burn_slow,
            "slo.alert_active": 1.0 if self.active else 0.0,
        }
        return events

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        return {
            "alert": self.name,
            "objective": self.cfg.objective,
            "fast_window_s": self.cfg.fast_window,
            "slow_window_s": self.cfg.slow_window,
            "burn_threshold": self.cfg.burn_threshold,
            "fired": self.fired,
            "resolved": self.resolved,
            "active": self.active,
        }
