"""Prediction cache with CLOCK eviction (paper §4.2).

The cache is a function cache for ``predict(m, x) -> y`` keyed by
``(model_id, digest(x))``. It exposes the paper's *non-blocking* request /
fetch API: ``request`` registers interest and reports presence without
computing; ``fetch`` returns the value if present. Because adaptive model
selection happens *above* the cache, selection changes never invalidate
entries (paper §4.2, last paragraph).

It also powers the feedback join (§5): predictions rendered moments ago are
re-fetched when feedback arrives, avoiding model re-evaluation — the paper's
1.6x feedback-throughput effect, reproduced in benchmarks/bench_cache.py."""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.core import metrics as M


def digest(x: Any) -> Hashable:
    """Stable digest of a query input (arrays hashed by content).

    Non-array leaves carry their type name: Python hashes ``1``, ``1.0``
    and ``True`` identically, so without it those collide as cache keys —
    and a ``list`` input would collide with the same-valued ``tuple``."""
    if isinstance(x, np.ndarray):
        return hashlib.blake2b(
            x.tobytes() + str(x.shape).encode() + str(x.dtype).encode(),
            digest_size=16).hexdigest()
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(digest(v) for v in x)
    return (type(x).__name__, x)


class ClockCache:
    """Fixed-capacity cache with the CLOCK (second-chance) eviction policy.

    O(1) get/put amortized; the hand skips referenced entries once, clearing
    their reference bit — the standard approximation of LRU the paper cites
    [Corbato '68]."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self._slots: List[Optional[Hashable]] = [None] * capacity
        self._ref: np.ndarray = np.zeros(capacity, dtype=bool)
        self._values: Dict[Hashable, Tuple[int, Any]] = {}   # key -> (slot, value)
        self._hand = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._values)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._values

    # --- paper's non-blocking API ---
    def request(self, key: Hashable) -> bool:
        """True if present (marks referenced); False means the caller should
        schedule computation and later ``put``."""
        entry = self._values.get(key)
        if entry is not None:
            self._ref[entry[0]] = True
            self.hits += 1
            return True
        self.misses += 1
        return False

    def fetch(self, key: Hashable) -> Optional[Any]:
        entry = self._values.get(key)
        if entry is None:
            return None
        self._ref[entry[0]] = True
        return entry[1]

    def put(self, key: Hashable, value: Any) -> None:
        entry = self._values.get(key)
        if entry is not None:                       # update in place
            self._values[key] = (entry[0], value)
            self._ref[entry[0]] = True
            return
        slot = self._find_slot()
        old_key = self._slots[slot]
        if old_key is not None:
            del self._values[old_key]
            self.evictions += 1
        self._slots[slot] = key
        self._values[key] = (slot, value)
        # classic CLOCK: new entries start unreferenced — they get one sweep
        # cycle to prove themselves, so churn can't flush referenced hot keys
        self._ref[slot] = False

    def _find_slot(self) -> int:
        if len(self._values) < self.capacity:
            # fast path: first empty slot from the hand
            for _ in range(self.capacity):
                if self._slots[self._hand] is None:
                    slot = self._hand
                    self._hand = (self._hand + 1) % self.capacity
                    return slot
                self._hand = (self._hand + 1) % self.capacity
        # CLOCK sweep: skip referenced entries once, clearing their bit
        while True:
            if self._ref[self._hand]:
                self._ref[self._hand] = False
                self._hand = (self._hand + 1) % self.capacity
            else:
                slot = self._hand
                self._hand = (self._hand + 1) % self.capacity
                return slot

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class PredictionCache:
    """(model_id, digest(x)) -> prediction, on top of ClockCache.

    When a ``MetricsRegistry`` is attached, every ``request`` is reported as
    a ``cache.hits`` / ``cache.misses`` increment — both globally and under
    the model's label, so ``report()['per_model'][m]['cache']`` breaks the
    hit rate down per model (the shared telemetry schema both stacks emit).
    The same mechanism serves as the pipeline *intermediate-result* cache:
    stage inputs are digested like any query, so two pipelines sharing a
    stage (same model id, same stage input) compute it once."""

    def __init__(self, capacity: int, metrics=None, tracer=None):
        self.cache = ClockCache(capacity)
        self.metrics = metrics
        # span tracing (repro.obs): probes annotate the querying trace
        self.tracer = tracer

    def __len__(self) -> int:
        return len(self.cache)

    def key(self, model_id: str, x: Any) -> Hashable:
        return (model_id, digest(x))

    def request(self, model_id: str, x: Any, *, parent=None,
                now: float = 0.0) -> bool:
        hit = self.cache.request(self.key(model_id, x))
        if self.metrics is not None:
            self.metrics.inc_both(M.CACHE_HITS if hit else M.CACHE_MISSES,
                                  model=model_id)
        if self.tracer is not None and parent is not None:
            # instant event under the query's root span: cache probes are
            # zero-duration in virtual time but decide the whole lifecycle
            self.tracer.event(parent, "hit" if hit else "miss",
                              "frontend.cache", now,
                              attrs={"model": model_id})
        return hit

    def fetch(self, model_id: str, x: Any) -> Optional[Any]:
        return self.cache.fetch(self.key(model_id, x))

    def put(self, model_id: str, x: Any, y: Any) -> None:
        self.cache.put(self.key(model_id, x), y)

    @property
    def hit_rate(self) -> float:
        return self.cache.hit_rate
