"""Fleet time-series telemetry: a clock-agnostic, seed-deterministic
sampler for the control plane's vital signs (DESIGN.md §15).

The run reports are end-of-run aggregates and the span log is per-query;
neither shows the fleet *evolve* — why the autoscaler grew at t=12.4s, when
the cache hit rate collapsed, how deep the flash-crowd backlog got before
admission started shedding. ``FleetSampler`` closes that gap: at a fixed
interval on the driving loop's virtual clock it polls registered *probes*
(stateful callables owned by the serving stacks) and appends each returned
gauge into a bounded per-series ring buffer.

Design rules, mirroring ``core.metrics`` / ``obs.tracer``:

* **Clock-agnostic** — the sampler never reads time. The drive loop calls
  ``sample_until(now)`` and samples are stamped at exact interval
  boundaries ``k * interval`` (computed multiplicatively, so a
  float-accumulated drive clock cannot skew the stamps).
* **Bounded memory** — each series keeps the newest ``capacity`` points;
  overwritten points are counted in ``dropped``, never silently.
* **Deterministic** — everything sampled is a pure function of the seeded
  run, and the serialized document sorts its keys, so two identical runs
  emit byte-identical ``repro.timeseries/v1`` JSON.

An optional ``BurnRateMonitor`` (obs.monitor) is consulted at every sample:
its windowed attainment/burn gauges join the series and its fire/resolve
alerts land in the document's ``events`` (and, when a tracer is bound, in
the span log as global events).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional

TIMESERIES_SCHEMA = "repro.timeseries/v1"

# probe signature: (now, dt) -> {series_name: float gauge}
Probe = Callable[[float, float], Dict[str, float]]


class SeriesRing:
    """Bounded ring of ``[t, value]`` points for one series, oldest first
    when read; the overwritten count is reported as ``dropped``."""

    __slots__ = ("capacity", "_buf", "_n")

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._buf: List[Optional[List[float]]] = [None] * capacity
        self._n = 0                     # total points ever appended

    def append(self, t: float, value: float) -> None:
        self._buf[self._n % self.capacity] = [float(t), float(value)]
        self._n += 1

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def points(self) -> List[List[float]]:
        """Retained points, oldest first."""
        if self._n <= self.capacity:
            return list(self._buf[: self._n])        # type: ignore[arg-type]
        h = self._n % self.capacity
        return self._buf[h:] + self._buf[:h]         # type: ignore[operator]


class FleetSampler:
    """Interval sampler over registered probes.

    The driving loop owns the timeline: it calls ``sample_until(now)``
    after advancing the clock, and the sampler emits one snapshot per
    elapsed interval boundary. Probes are registered by the stack being
    observed (``Clipper.timeseries_probe``, ``LMServer.timeseries_probe``,
    ``PipelineExecutor.timeseries_probe``); each returns a flat
    ``{series: gauge}`` dict for the current instant. A probe may grow the
    series set mid-run (e.g. a new ladder rung) — new series simply start
    at their first sample."""

    def __init__(self, *, interval: float, capacity: int = 4096,
                 monitor=None):
        assert interval > 0
        self.interval = float(interval)
        self.capacity = capacity
        self.monitor = monitor
        self.tracer = None
        self._probes: List[Probe] = []
        self._series: Dict[str, SeriesRing] = {}
        self._k = 0                     # boundaries emitted so far
        self.samples = 0
        self.events: List[Dict[str, Any]] = []

    # -- wiring ---------------------------------------------------------
    def add_probe(self, probe: Probe) -> None:
        self._probes.append(probe)

    def bind(self, *, metrics=None, tracer=None) -> None:
        """Late-bind the run's registries: the monitor needs the stack's
        ``MetricsRegistry`` (which exists only once the stack is built) and
        alert events mirror into the span log when a tracer is active."""
        if tracer is not None:
            self.tracer = tracer
        if self.monitor is not None and metrics is not None:
            self.monitor.bind(metrics)

    # -- sampling -------------------------------------------------------
    def record(self, name: str, t: float, value: float) -> None:
        ring = self._series.get(name)
        if ring is None:
            ring = self._series[name] = SeriesRing(self.capacity)
        ring.append(t, value)

    def sample(self, t: float) -> None:
        """Take one snapshot stamped ``t``: poll every probe, then the
        monitor (whose gauges + alert transitions ride along)."""
        self.samples += 1
        for probe in self._probes:
            vals = probe(t, self.interval)
            for name in sorted(vals):
                self.record(name, t, vals[name])
        if self.monitor is not None:
            for ev in self.monitor.observe(t):
                self.events.append(ev)
                if self.tracer is not None:
                    self.tracer.global_event(
                        f"alert.{ev['kind']}", "obs.monitor", t,
                        attrs={"alert": ev["alert"], **ev["evidence"]})
            for name in sorted(self.monitor.gauges):
                self.record(name, t, self.monitor.gauges[name])

    def sample_until(self, now: float) -> None:
        """Emit a snapshot at every interval boundary <= ``now``. Stamps
        are exact multiples of the interval (tolerating the drive loop's
        float-accumulated clock by a nanosecond-scale epsilon)."""
        while (self._k + 1) * self.interval <= now + 1e-9:
            self._k += 1
            self.sample(self._k * self.interval)

    # -- reading --------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """The ``repro.timeseries/v1`` document."""
        return {
            "schema": TIMESERIES_SCHEMA,
            "interval_s": self.interval,
            "capacity": self.capacity,
            "samples": self.samples,
            "series": {
                name: {"points": ring.points(), "total": ring.total,
                       "dropped": ring.dropped}
                for name, ring in sorted(self._series.items())
            },
            "events": list(self.events),
            "monitor": (self.monitor.summary()
                        if self.monitor is not None else None),
        }

    def to_json(self) -> str:
        """Stable JSON rendering — byte-identical for identical runs."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)
