"""What the per-layer readers (``bench/metrics/``) share: the traced run's
admission and decode calls inside the window, the program's prefill spans,
and the device time inside either kind of call."""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from bench import trace as TR


def admits(run, traced: bool = False) -> List[Dict]:
    """Admission calls that prefilled, started inside the window (and
    inside the profiled span where ``traced``)."""
    return [a for a in run.admits if run.in_window(a["t0"])
            and (a["traced"] or not traced)]


def decodes(run, traced: bool = False) -> List[Dict]:
    """Decode calls with an active slot, started inside the window (and
    inside the profiled span where ``traced``)."""
    return [d for d in run.decodes if run.in_window(d["t0"])
            and (d["traced"] or not traced)]


def untraced_decodes(run) -> List[Dict]:
    """Decode calls with an active slot inside the window but outside the
    profiled span: the readers on the host clock take these, since the
    profiler slows the host's side of a call."""
    return [d for d in decodes(run) if not d["traced"]]


def prefill_spans(run) -> List[Tuple[float, float, Dict]]:
    """The program's ``lm.prefill`` spans that start inside the window and
    end before the profiled span, one per dispatch (the engine gives each
    request of a batch the same span)."""
    prof = getattr(run, "profiled", None)
    cut = prof[0] if prof else float("inf")
    seen = {}
    for s in run.spans:
        if (s.component == "lm.prefill" and run.in_window(s.start)
                and s.end < cut):
            seen.setdefault((s.start, s.end), s.attrs or {})
    return [(a, b, attrs) for (a, b), attrs in sorted(seen.items())]


def decode_seconds(run) -> float:
    return sum(d["t1"] - d["t0"] for d in untraced_decodes(run))


def trace_spans(run, kind: str) -> List[Tuple[float, float]]:
    """Host intervals (profiler microseconds) of the labelled decode calls,
    or of the admission calls that launched device work (a prefill)."""
    if run.trace is None:
        return []
    if kind == "decode":
        return run.trace["decodes"]
    starts = sorted(s for _, s, _ in run.trace["device"])
    out = []
    for lo, hi in run.trace["admits"]:
        i = bisect.bisect_left(starts, lo)
        if i < len(starts) and starts[i] <= hi:
            out.append((lo, hi))
    return out


def idle_share(run, kind: str):
    """1 - the device's busy time inside the calls of ``kind`` over their
    host time, in %."""
    spans = trace_spans(run, kind)
    total = sum(hi - lo for lo, hi in spans)
    if not total:
        return None
    busy = TR.clip_union(run.trace["device"], spans)
    return 100.0 * (1.0 - busy / total)


def kernel_share(run, kind: str, names, bound_s: float):
    """Σ bound over the kernels' device time inside the calls of ``kind``,
    in %; None where the trace holds none of them."""
    us = TR.kernel_us(run.trace, names, trace_spans(run, kind)) \
        if run.trace is not None else 0.0
    if not us or not bound_s:
        return None
    return 100.0 * bound_s / (us / 1e6)
