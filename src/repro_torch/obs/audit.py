"""Control-plane decision audit log: every capacity decision, with the
evidence that justified it (DESIGN.md §15).

The cluster report says *what* happened (replicas added, queries shed);
the audit log says *why*: each autoscaler grow/drain, admission
shed/degrade, router pick, and fault detection/recovery/hedge/retry is
recorded with the decision-time inputs — the λ/E[s]/backlog/expected-delay
numbers the controller actually looked at — so any capacity decision in a
run is explainable after the fact.

Records live in a bounded ring (newest ``capacity`` kept, overwritten
count reported as ``dropped``); per-action counts are exact regardless of
drops, so invariants like "audit grow count == replicas added" hold even
on truncated logs. The serialized form is the ``repro.audit/v1`` document
— sorted keys, byte-identical per seed, like every other artifact.

Recording is opt-in per run (``--audit-out``): with no log attached every
instrumentation site is a single ``is not None`` check — zero per-query
overhead, the tracer's discipline.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional

AUDIT_SCHEMA = "repro.audit/v1"

# known (actor, action) vocabulary — validate warns on novelty, the log
# itself accepts anything (forward compatibility)
ACTIONS = {
    "autoscaler": ("grow", "drain"),
    "admission": ("shed", "degrade"),
    "router": ("pick",),
    "faults": ("detect", "recover", "hedge", "retry"),
}


def _clean(v: Any) -> Any:
    """JSON-safe evidence values: infinities (e.g. expected delay with no
    live replica) become None rather than non-standard ``Infinity``."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    return v


class AuditLog:
    """Bounded ring of control-plane decision records."""

    def __init__(self, capacity: int = 1 << 14):
        assert capacity > 0
        self.capacity = capacity
        self._buf: List[Optional[Dict[str, Any]]] = [None] * capacity
        self._n = 0                     # total records ever appended
        self.counts: Dict[str, int] = {}    # "actor.action" -> exact count

    def record(self, t: float, actor: str, action: str, *,
               model: Optional[str] = None,
               evidence: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        rec = {
            "seq": self._n,
            "t": float(t),
            "actor": actor,
            "action": action,
            "model": model,
            "evidence": _clean(evidence) if evidence else {},
        }
        self._buf[self._n % self.capacity] = rec
        self._n += 1
        key = f"{actor}.{action}"
        self.counts[key] = self.counts.get(key, 0) + 1
        return rec

    # -- reading --------------------------------------------------------
    def __len__(self) -> int:
        return min(self._n, self.capacity)

    @property
    def total(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def records(self) -> List[Dict[str, Any]]:
        """Retained records, oldest first."""
        if self._n <= self.capacity:
            return list(self._buf[: self._n])        # type: ignore[arg-type]
        h = self._n % self.capacity
        return self._buf[h:] + self._buf[:h]         # type: ignore[operator]

    def count(self, actor: str, action: str) -> int:
        """Exact count for one decision kind (drop-proof)."""
        return self.counts.get(f"{actor}.{action}", 0)

    def summary(self) -> Dict[str, Any]:
        return {
            "total": self._n,
            "dropped": self.dropped,
            "capacity": self.capacity,
            "counts": dict(sorted(self.counts.items())),
        }

    def to_dict(self) -> Dict[str, Any]:
        """The ``repro.audit/v1`` document."""
        return {
            "schema": AUDIT_SCHEMA,
            **self.summary(),
            "records": self.records(),
        }

    def to_json(self) -> str:
        """Stable JSON rendering — byte-identical for identical runs."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=2)
