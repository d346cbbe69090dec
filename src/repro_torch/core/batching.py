"""Adaptive batching (paper §4.3).

* ``AIMDController`` — additive-increase / multiplicative-decrease search for
  the largest batch size whose evaluation latency stays under the SLO
  (paper §4.3.1; small 10% backoff because the optimum is stable).
* ``QuantileRegressionController`` — the alternative the paper compares
  against: estimate P99 latency as a linear function of batch size via
  pinball-loss regression, invert for the SLO.
* ``BatchQueue`` — per-container queue with *delayed batching* (paper
  §4.3.2, Nagle-style) and max-batch admission.
* ``bucket`` — TPU adaptation (DESIGN.md §2): XLA needs static shapes, so
  dispatched batches are padded up a geometric bucket ladder; AIMD adapts
  admission while buckets bound recompilation.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import metrics as M
from repro_torch.core.interfaces import Query


# ---------------------------------------------------------------------------
# batch-size controllers
# ---------------------------------------------------------------------------

class AIMDController:
    """Additive-increase (+``additive``) until the SLO is exceeded, then a
    multiplicative backoff (x``backoff``). The paper uses a small backoff
    (10%) because the optimal batch size does not fluctuate much."""

    def __init__(self, slo: float, *, additive: int = 2, backoff: float = 0.9,
                 init: int = 1, max_batch: int = 4096):
        assert 0 < backoff < 1 and additive >= 1
        self.slo = slo
        self.additive = additive
        self.backoff = backoff
        self.cap = max_batch
        self._max = float(init)

    @property
    def max_batch_size(self) -> int:
        return max(1, int(self._max))

    def record(self, batch_size: int, latency: float) -> None:
        if batch_size < self.max_batch_size:
            return        # under-full batch: not informative about the limit
        if latency > self.slo:
            self._max = max(1.0, self._max * self.backoff)
        else:
            self._max = min(float(self.cap), self._max + self.additive)


class QuantileRegressionController:
    """Estimate latency_q(batch) ≈ a*batch + b at quantile ``q``, then set
    max_batch = (slo - b) / a.

    The latency profile is strongly linear (paper Fig 3), so the slope comes
    from ordinary least squares and the intercept from the empirical
    q-quantile of the residuals — a deterministic, scale-free estimator
    (pinball SGD at q=0.99 converges pathologically slowly). Exploration:
    until the window covers >= 2 distinct batch sizes, the bound grows
    additively like AIMD so the regression has signal to fit."""

    def __init__(self, slo: float, *, q: float = 0.99, window: int = 512,
                 max_batch: int = 4096, refit_every: int = 16):
        self.slo = slo
        self.q = q
        self.window: Deque[Tuple[int, float]] = deque(maxlen=window)
        self.cap = max_batch
        self.refit_every = refit_every
        self._n = 0
        self._a, self._b = 0.0, 0.0
        self._max = 1

    @property
    def max_batch_size(self) -> int:
        return self._max

    def record(self, batch_size: int, latency: float) -> None:
        self.window.append((batch_size, latency))
        self._n += 1
        # explore upward only until the regression has signal to fit
        if (self._a == 0.0 and latency <= self.slo
                and batch_size >= self._max):
            self._max = min(self.cap, self._max + 1)
        if self._n % self.refit_every == 0 and len(self.window) >= 8:
            self._fit()

    def _fit(self) -> None:
        data = np.asarray(self.window, dtype=np.float64)
        x, y = data[:, 0], data[:, 1]
        if np.ptp(x) < 1e-9:
            return                      # no batch-size variation yet
        a = float(np.cov(x, y, bias=True)[0, 1] / np.var(x))
        b = float(np.quantile(y - a * x, self.q))
        self._a, self._b = a, b
        if a <= 1e-12:
            self._max = self.cap
        else:
            self._max = int(np.clip((self.slo - b) / a, 1, self.cap))


class FixedController:
    """No adaptivity — the paper's 'no batching' / static baseline."""

    def __init__(self, size: int = 1):
        self._max = size

    @property
    def max_batch_size(self) -> int:
        return self._max

    def record(self, batch_size: int, latency: float) -> None:
        pass


# ---------------------------------------------------------------------------
# bucketed static shapes (TPU adaptation)
# ---------------------------------------------------------------------------

def bucket(n: int, *, ladder: Sequence[int] = (), cap: int = 4096) -> int:
    """Smallest ladder size >= n (default: powers of two up to cap; above
    the cap the exact size is returned — no padding, no recompile guard).

    The same function pads both dispatched *batch sizes* and — via an
    explicit ``ladder`` from :func:`prompt_length_ladder` — prompt
    *lengths*, so distinct compiled prefill shapes are bounded by
    ``len(batch rungs) * len(length rungs)`` instead of by the number of
    distinct (count, length) pairs in the workload."""
    if ladder:
        for b in ladder:
            if b >= n:
                return b
        return max(ladder[-1], n)
    b = 1
    while b < n and b < cap:
        b <<= 1
    return max(b, n) if n > cap else b


def prompt_length_ladder(cap: int, *, lo: int = 8,
                         factor: float = 2.0) -> Tuple[int, ...]:
    """Geometric prompt-length rungs ``lo, lo*factor, ...`` capped at
    ``cap`` (the cap itself is always the last rung, so every prompt that
    fits the cap pads to a rung). ``len(result)`` bounds the number of
    distinct prefill sequence lengths the engine can compile."""
    assert cap >= 1 and lo >= 1 and factor > 1.0
    rungs: List[int] = []
    v = min(lo, cap)
    while v < cap:
        rungs.append(int(v))
        v = max(int(v) + 1, int(math.ceil(v * factor)))
    rungs.append(int(cap))
    return tuple(rungs)


# ---------------------------------------------------------------------------
# per-container queue with delayed batching
# ---------------------------------------------------------------------------

@dataclass
class BatchQueue:
    """Adaptive batching queue for one model container (paper §4.3).

    ``batch_delay``: under moderate load, hold dispatch up to this long after
    the oldest enqueued query so more queries can join (paper §4.3.2).

    ``metrics`` / ``model_id``: when attached (frontend does this at
    construction), every dispatch reports queue depth, batch size, and
    per-model service time through the shared telemetry schema.

    ``tracer``: when attached (repro.obs), every dispatch additionally
    emits a global ``batch.dispatch`` trace event — the batch boundaries a
    flamegraph needs to explain queue-wait spans."""

    controller: AIMDController
    batch_delay: float = 0.0
    _q: Deque[Query] = field(default_factory=deque)
    metrics: Optional[object] = None
    model_id: Optional[str] = None
    tracer: Optional[object] = None

    def put(self, query: Query) -> None:
        self._q.append(query)

    def requeue_to(self, other: "BatchQueue",
                   keep: Optional[Callable[[Query], bool]] = None) -> int:
        """Hand every queued query to another queue, merge-ordered by
        arrival time (drain support: a retiring replica gives its backlog to
        a live one without dropping or reordering work). Returns the number
        of queries moved.

        ``keep`` filters the drain (failure recovery, DESIGN.md §14): only
        queries it accepts move; the rest — already finalized or shed, so
        recomputing them is pure waste — are dropped with the dead
        replica."""
        if other is self:
            return 0
        mine = list(self._q) if keep is None else \
            [q for q in self._q if keep(q)]
        moved = len(mine)
        if moved:
            merged = sorted(list(other._q) + mine,
                            key=lambda q: (q.arrival_time, q.query_id))
            other._q.clear()
            other._q.extend(merged)
        self._q.clear()
        return moved

    def __len__(self) -> int:
        return len(self._q)

    def oldest_arrival(self) -> Optional[float]:
        return self._q[0].arrival_time if self._q else None

    def ready(self, now: float) -> bool:
        if not self._q:
            return False
        if len(self._q) >= self.controller.max_batch_size:
            return True
        return (now - self._q[0].arrival_time) >= self.batch_delay

    def next_batch(self, now: float) -> List[Query]:
        """Dequeue up to the controller's current max batch size."""
        depth = len(self._q)
        n = min(depth, self.controller.max_batch_size)
        batch = [self._q.popleft() for _ in range(n)]
        if self.tracer is not None and batch:
            self.tracer.global_event(
                "dispatch", "frontend.batch", now,
                attrs={"model": self.model_id, "size": n, "depth": depth})
        if self.metrics is not None and batch:
            self.metrics.observe(M.QUEUE_DEPTH, depth)
            if self.model_id is not None:
                self.metrics.observe_both(M.BATCH_SIZE, n, model=self.model_id)
                self.metrics.inc_both(M.BATCHES, model=self.model_id)
                self.metrics.inc(M.QUERIES_SUBMITTED, n, model=self.model_id)
            else:
                self.metrics.observe(M.BATCH_SIZE, n)
                self.metrics.inc(M.BATCHES)
        return batch

    def record(self, batch_size: int, latency: float) -> None:
        self.controller.record(batch_size, latency)
        if self.metrics is not None:
            if self.model_id is not None:
                self.metrics.observe_both(M.SERVICE, latency,
                                          model=self.model_id)
            else:
                self.metrics.observe(M.SERVICE, latency)
