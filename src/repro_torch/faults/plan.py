"""Seeded, clock-agnostic fault-injection plans (DESIGN.md §14), counterpart
of ``repro.faults.plan`` (a copy).

Clipper's robustness claim (paper §1, §4.4) is that the serving layer keeps
rendering accurate, low-latency predictions *despite* failing and straggling
model containers. A ``FaultPlan`` makes that claim testable: it is a frozen
description of what goes wrong — replica crashes, crash-then-recover
schedules, transient per-batch errors, latency-degradation windows — that
can be attached to any workload/cluster/pipeline scenario. Everything is a
pure function of (plan seed, virtual time, replica identity): the plan
never reads a wall clock and every random stream is seeded per replica, so
a faulted run is byte-identical from its seed, exactly like a healthy one.

Ground truth vs observation: the plan drives what *actually* happens inside
``TorchModelContainer.pred_batch_timed`` (raise on crash, raise transient
errors, multiply service time). The serving layer never reads the plan —
it must *detect* failures through missed completions and recover through
requeue/retry/hedge (``Clipper`` with a :class:`RecoveryPolicy`), the same
information boundary a real cluster has.

Spec grammar (CLI ``--fault`` and :meth:`FaultPlan.from_specs`):

* ``crash:<model>:<replica>@<at>`` — permanent crash at virtual second
  ``at``; every batch in flight or dispatched after is silently lost.
* ``crash:<model>:<replica>@<at>:<recover_at>`` — crash-then-recover: the
  replica is dead on ``[at, recover_at)`` and serves normally after.
* ``flaky:<model>:<replica>:<p>`` — each dispatched batch fails fast with
  probability ``p`` (an error response, not a silent loss).
* ``slow:<model>:<replica>:<factor>`` — multiply every service time by
  ``factor`` (latency degradation / brownout).
* ``slow:<model>:<replica>:<factor>@<from>:<until>`` — degradation window.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.containers import (ContainerCrashed, ReplicaSet,
                                         TransientError)

KINDS = ("crash", "flaky", "slow")


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault on one replica of one model."""

    kind: str                       # crash | flaky | slow
    model: str
    replica: int
    at: float = 0.0                 # crash time (crash)
    recover_at: Optional[float] = None   # None = permanent (crash)
    p_error: float = 0.0            # per-batch error probability (flaky)
    factor: float = 1.0             # service-time multiplier (slow)
    slow_from: float = 0.0          # degradation window (slow)
    slow_until: float = float("inf")

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}: {self.kind!r}")
        if self.replica < 0:
            raise ValueError(f"replica must be >= 0: {self.replica}")
        if self.kind == "crash" and self.recover_at is not None \
                and self.recover_at <= self.at:
            raise ValueError(
                f"recover_at {self.recover_at} must be > at {self.at}")
        if self.kind == "flaky" and not 0.0 <= self.p_error <= 1.0:
            raise ValueError(f"p_error must be in [0, 1]: {self.p_error}")
        if self.kind == "slow" and self.factor <= 0.0:
            raise ValueError(f"factor must be > 0: {self.factor}")

    def describe(self) -> str:
        """Canonical spec string (round-trips through ``parse_fault``)."""
        if self.kind == "crash":
            s = f"crash:{self.model}:{self.replica}@{self.at:g}"
            return s + (f":{self.recover_at:g}"
                        if self.recover_at is not None else "")
        if self.kind == "flaky":
            return f"flaky:{self.model}:{self.replica}:{self.p_error:g}"
        s = f"slow:{self.model}:{self.replica}:{self.factor:g}"
        if self.slow_from > 0.0 or self.slow_until != float("inf"):
            return s + f"@{self.slow_from:g}:{self.slow_until:g}"
        return s


def parse_fault(spec: str) -> FaultSpec:
    """Parse one ``--fault`` spec string (grammar in the module docstring)."""
    try:
        kind, rest = spec.split(":", 1)
        if kind == "crash":
            head, at_part = rest.split("@", 1)
            model, replica = head.rsplit(":", 1)
            times = at_part.split(":")
            if len(times) not in (1, 2):
                raise ValueError("expected @<at> or @<at>:<recover_at>")
            return FaultSpec("crash", model, int(replica),
                             at=float(times[0]),
                             recover_at=(float(times[1])
                                         if len(times) == 2 else None))
        if kind == "flaky":
            model, replica, p = rest.rsplit(":", 2)
            return FaultSpec("flaky", model, int(replica), p_error=float(p))
        if kind == "slow":
            if "@" in rest:
                head, win = rest.split("@", 1)
                lo, hi = win.split(":")
                model, replica, factor = head.rsplit(":", 2)
                return FaultSpec("slow", model, int(replica),
                                 factor=float(factor), slow_from=float(lo),
                                 slow_until=float(hi))
            model, replica, factor = rest.rsplit(":", 2)
            return FaultSpec("slow", model, int(replica),
                             factor=float(factor))
        raise ValueError(f"unknown fault kind {kind!r}; have {KINDS}")
    except (ValueError, IndexError) as e:
        raise ValueError(f"bad fault spec {spec!r}: {e}") from None


class ReplicaFaults:
    """Runtime fault state for one replica — the merged view of every spec
    targeting it, with its own seeded rng stream for transient errors.

    Consumed by ``TorchModelContainer.pred_batch_timed(inputs, now=...)``:
    ``check_dispatch`` raises before any compute when the replica is dead or
    rolls a transient error; ``multiplier`` scales the modeled service time;
    ``check_service`` loses the batch when the crash strikes mid-service.
    All decisions are functions of (seed stream, virtual now) only."""

    def __init__(self, *, crash_at: Optional[float] = None,
                 recover_at: Optional[float] = None, p_error: float = 0.0,
                 factor: float = 1.0, slow_from: float = 0.0,
                 slow_until: float = float("inf"),
                 rng: Optional[np.random.Generator] = None):
        self.crash_at = crash_at
        self.recover_at = recover_at
        self.p_error = p_error
        self.factor = factor
        self.slow_from = slow_from
        self.slow_until = slow_until
        self.rng = rng if rng is not None else np.random.default_rng(0)

    def crashed(self, now: float) -> bool:
        """Ground truth: is the replica dead at ``now``? (The serving layer
        must not call this for routing — detection is its job; only the
        recovery *probe* consults it, modeling a health check that the
        replica answers once it is back.)"""
        return (self.crash_at is not None and now >= self.crash_at
                and (self.recover_at is None or now < self.recover_at))

    def multiplier(self, now: float) -> float:
        """Service-time multiplier in effect at ``now`` (1.0 = healthy)."""
        if self.factor != 1.0 and self.slow_from <= now < self.slow_until:
            return self.factor
        return 1.0

    def check_dispatch(self, now: float) -> None:
        """Raise if a batch dispatched at ``now`` does not execute."""
        if self.crashed(now):
            raise ContainerCrashed(f"replica crashed at {self.crash_at}")
        if self.p_error and self.rng.random() < self.p_error:
            raise TransientError("injected transient batch error")

    def check_service(self, now: float, service: float) -> None:
        """Raise if the crash strikes while the batch is executing — the
        work is lost even though dispatch succeeded."""
        if (self.crash_at is not None
                and now < self.crash_at <= now + service):
            raise ContainerCrashed(
                f"replica crashed mid-service at {self.crash_at}")


@dataclass(frozen=True)
class FaultPlan:
    """A reproducible set of injected faults: specs + the seed every
    transient-error stream derives from. Attach with :func:`attach_faults`;
    replicas the autoscaler adds later are fresh hardware and get none."""

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0

    @classmethod
    def from_specs(cls, specs: Sequence[Union[str, FaultSpec]],
                   seed: int = 0) -> "FaultPlan":
        parsed = tuple(parse_fault(s) if isinstance(s, str) else s
                       for s in specs)
        return cls(parsed, seed)

    def describe(self) -> Tuple[str, ...]:
        return tuple(s.describe() for s in self.specs)

    def for_replica(self, model: str, replica: int
                    ) -> Optional[ReplicaFaults]:
        """Merged runtime fault state for one replica (None = healthy).
        At most one crash window per replica; later crash specs override
        earlier ones. The rng stream is seeded from (plan seed, model,
        replica) so independently-constructed plans with the same seed roll
        identical error streams."""
        mine = [s for s in self.specs
                if s.model == model and s.replica == replica]
        if not mine:
            return None
        kw: Dict = {}
        for s in mine:
            if s.kind == "crash":
                kw["crash_at"], kw["recover_at"] = s.at, s.recover_at
            elif s.kind == "flaky":
                kw["p_error"] = s.p_error
            else:
                kw["factor"] = s.factor
                kw["slow_from"], kw["slow_until"] = s.slow_from, s.slow_until
        rng = np.random.default_rng(
            [self.seed & 0x7FFFFFFF, zlib.crc32(model.encode()),
             replica, 23])
        return ReplicaFaults(rng=rng, **kw)


@dataclass(frozen=True)
class RecoveryPolicy:
    """How the frontend survives the plan (DESIGN.md §14).

    * **Detection** — every dispatched batch arms a timeout at
      ``max(detect_factor × E[service], min_timeout)`` (``min_timeout``
      ``None`` = the SLO). A missed completion marks the replica suspected
      (out of routing), drains its queued backlog to a live replica via the
      ordinary ``requeue_to`` path, and retries the lost batch.
    * **Retries** — per-query per-model budget of ``max_retries``
      re-dispatches with exponential backoff ``backoff_base × 2^attempt``;
      exhausted queries fall back to straggler mitigation (render without
      the failed model at the deadline).
    * **Hedging** — when a batch outlives ``max(hedge_factor × E[service],
      hedge_min)`` (``hedge_min`` ``None`` = half the SLO), its unanswered
      queries are re-enqueued once on the best alternate replica;
      whichever copy completes first wins.
    * **Recovery** — suspected replicas are health-probed each dispatch
      round; once the fault window has passed they rejoin routing.
    """

    detect_factor: float = 6.0
    min_timeout: Optional[float] = None       # None = the frontend SLO
    max_retries: int = 2
    backoff_base: float = 0.002
    hedge: bool = True
    hedge_factor: float = 3.0
    hedge_min: Optional[float] = None         # None = half the SLO


@dataclass(frozen=True)
class RequestFaults:
    """Per-request transient failures for the continuous-batching LMServer:
    request ``rid`` fails with probability ``p_error``, decided by a pure
    hash of (seed, rid) — order-independent, byte-identical per seed. A
    failed request still finishes decoding (the tokens exist) but carries
    ``Request.failed = True`` for downstream policy — ``LMCascade``
    escalates failed drafts and degrades failed verifies to the draft
    answer."""

    p_error: float = 0.0
    seed: int = 0

    def failed(self, request_id: int) -> bool:
        from repro_torch.obs.tracer import sample_decision
        # decorrelate from the tracer's sampling decisions on the same ids
        return sample_decision(self.seed ^ 0x5DEECE66D, request_id + 1,
                               self.p_error)


def attach_faults(replica_sets: Dict[str, ReplicaSet],
                  plan: FaultPlan) -> int:
    """Install the plan's per-replica fault state on existing containers;
    returns the number of replicas faulted. Specs naming unknown models or
    out-of-range replica slots raise (a silently inert fault plan would
    make a passing robustness test meaningless)."""
    known = set(replica_sets)
    for s in plan.specs:
        if s.model not in known:
            raise KeyError(f"fault spec {s.describe()!r}: unknown model "
                           f"{s.model!r}; have {sorted(known)}")
        if s.replica >= len(replica_sets[s.model].replicas):
            raise KeyError(f"fault spec {s.describe()!r}: model {s.model!r} "
                           f"has {len(replica_sets[s.model].replicas)} "
                           "replica slots")
    n = 0
    for mid, rs in replica_sets.items():
        for ri in range(len(rs.replicas)):
            rf = plan.for_replica(mid, ri)
            if rf is not None:
                rs.set_faults(ri, rf)
                n += 1
    return n
