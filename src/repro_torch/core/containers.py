"""Model containers (paper §4.4).

Counterpart of ``repro.core.containers``. ``TorchModelContainer`` wraps any
predict function behind the uniform ``pred_batch`` interface, with the
reference's bucket-padded batch shapes (on the card they bound the shapes a
model sees, as they bound XLA compiles there).

``service_time`` is pluggable: ``measured`` wall-clock (real execution) or a
calibrated latency model (cluster-scale benches + straggler injection —
paper Figs 6 & 9). ``ReplicaSet`` scales a container across replicas, each
with its *own* adaptive batching queue (paper §4.4.1)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.batching import AIMDController, BatchQueue, bucket


LatencyModel = Callable[[int], float]    # batch_size -> service seconds


class ContainerFault(RuntimeError):
    """A dispatched batch did not produce predictions (DESIGN.md §14)."""


class ContainerCrashed(ContainerFault):
    """The replica process is down: the batch is *silently lost* — no error
    response ever comes back, only a missed completion a failure detector
    can notice."""


class TransientError(ContainerFault):
    """The replica answered the batch with an error (fail-fast): the work is
    lost but the caller learns immediately and may retry."""

# Default-stream spawner for latency models constructed without an explicit
# rng: every call takes its own child of this seed sequence, so two
# independently-constructed containers draw *independent* jitter/straggler
# streams (with a shared default_rng(0) they straggled in lockstep).
# Construction order is deterministic, so runs stay reproducible.
_DEFAULT_LATENCY_SEEDS = np.random.SeedSequence(0)


def linear_latency(base: float, per_item: float,
                   jitter: float = 0.0, p_straggle: float = 0.0,
                   straggle_factor: float = 10.0,
                   rng: Optional[np.random.Generator] = None) -> LatencyModel:
    """The paper's empirically-observed linear latency profile (Fig 3), with
    optional straggler injection for §5.2.2 experiments."""
    if rng is None:
        rng = np.random.default_rng(_DEFAULT_LATENCY_SEEDS.spawn(1)[0])

    def model(n: int) -> float:
        t = base + per_item * n
        if jitter:
            t *= float(1.0 + rng.normal(0, jitter))
        if p_straggle and rng.random() < p_straggle:
            t *= straggle_factor
        return max(t, 1e-6)

    return model


def _to_numpy(y: Any) -> np.ndarray:
    """A predict function's output on the host, as numpy."""
    if isinstance(y, torch.Tensor):
        y = y.cpu()
    return np.asarray(y)


@dataclass
class ContainerStats:
    batches: int = 0
    queries: int = 0
    busy_time: float = 0.0
    failures: int = 0


class TorchModelContainer:
    """Uniform batch-prediction container around a predict callable (the
    counterpart of ``repro.core.containers.JaxModelContainer``).

    predict_fn: np.ndarray [B, ...] -> np.ndarray or tensor [B, ...] (on any
    device); inputs are padded to the bucket ladder, as in the reference."""

    def __init__(self, model_id: str, predict_fn: Callable,
                 *, latency_model: Optional[LatencyModel] = None,
                 bucket_cap: int = 4096, fail: bool = False):
        self.model_id = model_id
        self._fn = predict_fn
        self.latency_model = latency_model
        self.bucket_cap = bucket_cap
        self.stats = ContainerStats()
        self.fail = fail            # health: failed containers are skipped
        self.faults = None          # Optional[ReplicaFaults] — DESIGN.md §14

    def pred_batch(self, inputs: Sequence[Any]) -> List[Any]:
        ys, _ = self.pred_batch_timed(inputs)
        return ys

    def pred_batch_timed(self, inputs: Sequence[Any],
                         now: Optional[float] = None):
        """Returns (outputs, service_time). service_time is measured when no
        latency model is installed, modeled otherwise.

        With a fault model attached (``self.faults``) and a dispatch time,
        the batch is subject to injected failures: ``ContainerCrashed`` when
        the replica is down at dispatch or crashes mid-service (the batch is
        silently lost), ``TransientError`` on a seeded per-batch error roll
        (fail-fast), and latency-degradation multipliers on the modeled
        service time. Every raised fault increments ``stats.failures``."""
        if self.faults is not None and now is not None:
            try:
                self.faults.check_dispatch(now)
            except ContainerFault:
                self.stats.failures += 1
                raise
        n = len(inputs)
        x = np.stack([np.asarray(v) for v in inputs])
        nb = bucket(n, cap=self.bucket_cap)
        if nb != n:
            pad = np.repeat(x[-1:], nb - n, axis=0)
            x = np.concatenate([x, pad], axis=0)
        t0 = time.perf_counter()
        # the copy to the host ends the measured window: a CUDA result is
        # only ready once it has been copied (the reference's np.asarray
        # blocks the same way)
        y = _to_numpy(self._fn(x))
        measured = time.perf_counter() - t0
        service = (self.latency_model(n) if self.latency_model is not None
                   else measured)
        if self.faults is not None and now is not None:
            service *= self.faults.multiplier(now)
            try:
                self.faults.check_service(now, service)
            except ContainerFault:
                self.stats.failures += 1
                raise
        self.stats.batches += 1
        self.stats.queries += n
        self.stats.busy_time += service
        return [y[i] for i in range(n)], service


class ReplicaSet:
    """Container replicas with per-replica adaptive batching (paper §4.4.1).

    Replicas may have heterogeneous performance (different latency models);
    dispatch picks the earliest-free replica.

    The set is *dynamic* (control plane, DESIGN.md §10): ``add_replica``
    grows capacity mid-run and ``retire_replica`` shrinks it gracefully —
    the retiring replica's backlog is requeued to a live replica and its
    in-flight batch finishes before the slot is reaped. Slots are never
    reused, so replica indices held by in-flight completion events stay
    valid for the whole run."""

    def __init__(self, replicas: Sequence[TorchModelContainer],
                 make_controller: Callable[[], AIMDController],
                 batch_delay: float = 0.0):
        assert replicas
        self.model_id = replicas[0].model_id
        self.replicas = list(replicas)
        self._make_controller = make_controller
        self._batch_delay = batch_delay
        self._metrics = None
        self._tracer = None
        self.queues = [BatchQueue(make_controller(), batch_delay)
                       for _ in replicas]
        self.free_at = [0.0 for _ in replicas]
        self.draining = [False for _ in replicas]
        self.retired = [False for _ in replicas]
        # failure detection / recovery state (DESIGN.md §14): replica
        # indices the frontend's detector has marked unhealthy (fail=True)
        # and may later clear via probe_recovered. has_faults flags that a
        # fault plan is attached so hot paths can skip fault handling
        # entirely when the set is guaranteed healthy.
        self.suspected: set = set()
        self.has_faults = False

    def attach_metrics(self, metrics) -> None:
        """Point every queue (current or replaced) at a shared registry —
        call this again after swapping queues so per-model telemetry
        survives reconstruction."""
        self._metrics = metrics
        for queue in self.queues:
            queue.metrics = metrics
            queue.model_id = self.model_id

    def attach_tracer(self, tracer) -> None:
        """Point every queue (current or future) at a shared span tracer
        (repro.obs) — the same contract as ``attach_metrics``."""
        self._tracer = tracer
        for queue in self.queues:
            queue.tracer = tracer

    def healthy(self) -> List[int]:
        return [i for i, r in enumerate(self.replicas)
                if not r.fail and not self.retired[i]]

    def routable(self) -> List[int]:
        """Replicas eligible for *new* work: healthy and not draining."""
        return [i for i in self.healthy() if not self.draining[i]]

    def candidates(self) -> List[int]:
        """The one enqueue-eligibility chain routing shares: routable
        replicas, else merely healthy (everything draining), else every
        slot (everything failed — keep accepting work so recovery can
        drain it)."""
        return (self.routable() or self.healthy()
                or list(range(len(self.queues))))

    @property
    def n_live(self) -> int:
        return len(self.routable())

    # -- dynamic capacity (control plane) -------------------------------
    def add_replica(self, container: TorchModelContainer,
                    now: float = 0.0) -> int:
        """Grow capacity with a fresh replica (own queue + controller);
        returns its index. Telemetry attaches automatically when a registry
        was installed."""
        assert container.model_id == self.model_id
        queue = BatchQueue(self._make_controller(), self._batch_delay)
        if self._metrics is not None:
            queue.metrics = self._metrics
            queue.model_id = self.model_id
        if self._tracer is not None:
            queue.tracer = self._tracer
        self.replicas.append(container)
        self.queues.append(queue)
        self.free_at.append(float(now))
        self.draining.append(False)
        self.retired.append(False)
        return len(self.replicas) - 1

    def retire_replica(self, ri: int, now: float = 0.0) -> None:
        """Begin a graceful drain: the replica stops receiving new work,
        its queued backlog moves to the least-loaded live replica, and its
        in-flight batch (if any) runs to completion before ``reap``
        finalizes the slot."""
        if self.retired[ri] or self.draining[ri]:
            return
        targets = [i for i in self.routable() if i != ri]
        if not targets:
            raise ValueError("cannot retire the last live replica")
        self.draining[ri] = True
        tgt = min(targets, key=lambda i: (len(self.queues[i]), i))
        self.queues[ri].requeue_to(self.queues[tgt])
        self.reap(now)

    def reap(self, now: float) -> None:
        """Finalize draining replicas whose in-flight work has completed."""
        for i in range(len(self.replicas)):
            if (self.draining[i] and not self.retired[i]
                    and not self.queues[i] and self.free_at[i] <= now):
                self.draining[i] = False
                self.retired[i] = True

    # -- fault injection + recovery (DESIGN.md §14) ---------------------
    def set_faults(self, ri: int, faults) -> None:
        """Install a per-replica fault model (``repro.faults.ReplicaFaults``)
        on an existing replica slot."""
        self.replicas[ri].faults = faults
        self.has_faults = True

    def probe_recovered(self, now: float) -> List[int]:
        """Health-probe detector-suspected replicas; clear the ``fail`` mark
        on any whose fault window has passed and return the rejoined
        indices. Only detector-marked replicas are probed — a static
        ``fail=True`` the harness set by hand is never overridden."""
        rejoined = []
        for ri in sorted(self.suspected):
            if self.retired[ri]:
                self.suspected.discard(ri)
                continue
            f = self.replicas[ri].faults
            if f is None or not f.crashed(now):
                self.replicas[ri].fail = False
                self.suspected.discard(ri)
                # the replica restarts idle: stale busy-until estimates from
                # before the crash must not keep repelling (or attracting)
                # traffic
                self.free_at[ri] = float(now)
                rejoined.append(ri)
        return rejoined

    def est_service(self, ri: int, default: float = 0.0) -> float:
        """Observed mean service seconds per query for one replica (its
        cumulative busy time over queries served) — the per-replica stat
        heterogeneity-aware routing and the autoscaler's queueing model
        consume."""
        st = self.replicas[ri].stats
        return st.busy_time / st.queries if st.queries else default

    def expected_completion(self, ri: int, now: float,
                            default: float = 0.0) -> float:
        """Expected time from ``now`` until a query enqueued on replica
        ``ri`` would finish: residual busy time plus the backlog (and the
        query itself) at the observed per-query service estimate. The one
        ECT formula both the router and admission control consume."""
        wait = max(self.free_at[ri] - now, 0.0)
        est = self.est_service(ri, default)
        return wait + (len(self.queues[ri]) + 1) * est

    def mean_service(self, default: float = 0.0) -> float:
        """Set-wide mean service seconds per query across every replica."""
        busy = sum(r.stats.busy_time for r in self.replicas)
        queries = sum(r.stats.queries for r in self.replicas)
        return busy / queries if queries else default

    def replica_stats(self) -> List[Dict[str, Any]]:
        """Per-replica accounting snapshot (control-plane introspection)."""
        return [{
            "replica": i,
            "batches": r.stats.batches,
            "queries": r.stats.queries,
            "busy_time": r.stats.busy_time,
            "queued": len(self.queues[i]),
            "draining": self.draining[i],
            "retired": self.retired[i],
            "failures": r.stats.failures,
            "failed": r.fail,
        } for i, r in enumerate(self.replicas)]
