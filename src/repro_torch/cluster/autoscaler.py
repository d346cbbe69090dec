"""Per-model reactive autoscaling (DESIGN.md §10); counterpart of
``repro.cluster.autoscaler`` (a copy).

Clipper scales throughput by replicating containers (paper §4.4.1, Fig 6)
but provisions them statically; InferLine's observation is that tight
latency objectives under time-varying load need a controller that
continuously re-provisions. ``Autoscaler`` closes that loop: each control
tick it samples the shared telemetry (routed arrival rate, backlog, mean
service time) and grows or drains the model's ``ReplicaSet``.

Target replica count combines two deterministic signals:

* **queueing model** — keep utilization under a cap:
  ``n_rate = ceil(lambda * E[service] / utilization_cap)`` where ``lambda``
  is the routed-queries rate over the last tick and ``E[service]`` the
  observed mean service seconds per query;
* **backlog drain** — clear the standing queue within ``drain_target``
  seconds (default: the SLO): ``n_backlog = ceil(backlog * E[service] /
  drain_target)``.

Hysteresis is asymmetric, the classic flash-crowd shape: scale **up**
immediately (after ``up_ticks`` consecutive ticks of demand, default 1) by
as many replicas as the target asks; scale **down** only after
``down_ticks`` consecutive low-demand ticks, then one replica per tick, so
a lull inside a burst never collapses capacity. Retired replicas drain
gracefully (``ReplicaSet.retire_replica``) — queued work is requeued, the
in-flight batch finishes.

Everything the controller reads is a pure function of the virtual-clock
run, so an autoscaled scenario remains byte-identical from its seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import metrics as M
from repro_torch.core.containers import ReplicaSet, TorchModelContainer
from repro_torch.core.metrics import MetricsRegistry


@dataclass(frozen=True)
class AutoscalerConfig:
    tick: float = 0.05              # control period (virtual seconds)
    utilization_cap: float = 0.7    # rho target for the queueing model
    drain_target: Optional[float] = None   # backlog drain seconds (None=SLO)
    min_replicas: int = 1
    max_replicas: int = 8
    up_ticks: int = 1               # consecutive high ticks before growing
    down_ticks: int = 4             # consecutive low ticks before draining


class Autoscaler:
    """Reactive controller for one model's ReplicaSet.

    ``make_replica(model_id) -> TorchModelContainer`` supplies fresh
    replicas; in calibrated simulation it must seed each new container's
    latency model deterministically (see ``plan.replica_factory``).

    ``slo`` may be a float or a zero-arg callable returning one — the
    pipeline stack passes the model's *stage share* of the pipeline SLO as
    a callable so the drain target follows the planner's live replans."""

    def __init__(self, rs: ReplicaSet,
                 make_replica: Callable[[str], TorchModelContainer],
                 metrics: MetricsRegistry, cfg: AutoscalerConfig, *,
                 slo: float, audit=None):
        assert cfg.min_replicas >= 1
        self.rs = rs
        self.make_replica = make_replica
        self.metrics = metrics
        self.cfg = cfg
        self.slo = slo
        self.audit = audit              # optional repro_torch.obs AuditLog
        self.model_id = rs.model_id
        self._last_routed = metrics.counter(M.QUERIES_ROUTED,
                                            model=self.model_id)
        self._up_streak = 0
        self._down_streak = 0
        self.events: List[Dict[str, Any]] = []     # scale actions, reported
        self.timeline: List[List[float]] = []      # [t, live] per tick
        self.peak_live = rs.n_live

    # ------------------------------------------------------------------
    def desired(self, lam: float) -> int:
        """Deterministic replica target — a pure function of the arrival
        rate ``lam`` (routed qps over the last tick) and the replica set's
        current backlog + service stats."""
        return self._target(lam)[0]

    def _target(self, lam: float) -> tuple:
        """(want, evidence): the replica target plus the decision-time
        inputs that produced it, recorded verbatim into the audit log."""
        cfg = self.cfg
        est = self.rs.mean_service()
        # every non-retired slot's queue counts: work stranded on a crashed
        # (detector-failed) replica is still demand the survivors must
        # absorb, so lost capacity re-provisions instead of hiding the
        # backlog (DESIGN.md §14). For healthy runs this matches the old
        # routable-only sum — draining queues are empty post-requeue.
        backlog = sum(len(q) for i, q in enumerate(self.rs.queues)
                      if not self.rs.retired[i])
        evidence: Dict[str, Any] = {
            "lambda": lam, "est_service_s": est, "backlog": backlog,
        }
        if est <= 0.0:
            evidence.update(n_rate=0, n_backlog=0, want=cfg.min_replicas)
            return cfg.min_replicas, evidence      # no signal yet
        slo = self.slo() if callable(self.slo) else self.slo
        drain = cfg.drain_target if cfg.drain_target is not None else slo
        n_rate = math.ceil(lam * est / cfg.utilization_cap)
        n_backlog = math.ceil(backlog * est / drain) if drain > 0 else 0
        want = min(max(n_rate, n_backlog, cfg.min_replicas),
                   cfg.max_replicas)
        evidence.update(drain_target_s=drain, n_rate=n_rate,
                        n_backlog=n_backlog, want=want)
        return want, evidence

    def tick(self, now: float) -> None:
        """One control period: reap finished drains, sample the routed
        arrival rate, compare the target to live capacity, apply
        hysteresis, act."""
        cfg = self.cfg
        self.rs.reap(now)
        routed = self.metrics.counter(M.QUERIES_ROUTED, model=self.model_id)
        lam = (routed - self._last_routed) / cfg.tick
        self._last_routed = routed
        want, evidence = self._target(lam)
        live = self.rs.n_live
        if want > live:
            self._down_streak = 0
            self._up_streak += 1
            if self._up_streak >= cfg.up_ticks:
                for _ in range(want - live):
                    self.rs.add_replica(self.make_replica(self.model_id),
                                        now=now)
                    self.metrics.inc(M.REPLICAS_ADDED, model=self.model_id)
                    if self.audit is not None:
                        # one record per replica added, so the audit grow
                        # count equals the report's replicas_added counter
                        self.audit.record(
                            now, "autoscaler", "grow", model=self.model_id,
                            evidence={**evidence, "live": self.rs.n_live})
                self._up_streak = 0
                self.events.append({"t": now, "action": "up",
                                    "want": want, "live": self.rs.n_live})
        elif want < live and live > cfg.min_replicas:
            self._up_streak = 0
            self._down_streak += 1
            if self._down_streak >= cfg.down_ticks:
                # one replica per tick once the streak is earned; retire the
                # slowest routable replica (ties: the most recently added)
                ri = max(self.rs.routable(),
                         key=lambda i: (self.rs.est_service(i), i))
                self.rs.retire_replica(ri, now=now)
                self.metrics.inc(M.REPLICAS_RETIRED, model=self.model_id)
                if self.audit is not None:
                    self.audit.record(
                        now, "autoscaler", "drain", model=self.model_id,
                        evidence={**evidence, "replica": ri,
                                  "replica_est_service_s":
                                      self.rs.est_service(ri),
                                  "live": self.rs.n_live})
                self._down_streak = cfg.down_ticks    # stay armed while low
                self.events.append({"t": now, "action": "down",
                                    "want": want, "live": self.rs.n_live})
        else:
            self._up_streak = 0
            self._down_streak = 0
        live = self.rs.n_live
        self.peak_live = max(self.peak_live, live)
        self.timeline.append([round(now, 9), live])

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Control-plane section of the run report."""
        return {
            "model": self.model_id,
            "live": self.rs.n_live,
            "peak_live": self.peak_live,
            "total_slots": len(self.rs.replicas),
            "added": self.metrics.counter(M.REPLICAS_ADDED,
                                          model=self.model_id),
            "retired": self.metrics.counter(M.REPLICAS_RETIRED,
                                            model=self.model_id),
            "events": self.events,
            "timeline": self.timeline,
            "replicas": self.rs.replica_stats(),
        }
