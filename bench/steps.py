"""What the readers of the engine's step spans share (``LMServer``'s
``engine.admit`` and ``engine.decode`` spans and their children, through
the program's tracer, ``repro_torch/obs/tracer.py``): the step spans that
start inside the
window and end before the profiled span, and their children's times.

A program without step spans gives none, and each reader None."""

from __future__ import annotations

from typing import Dict, List


def steps(run, name: str) -> List:
    """The step spans called ``name`` that start inside the window and end
    before the profiled span (the profiler slows the host's side)."""
    prof = getattr(run, "profiled", None)
    cut = prof[0] if prof else float("inf")
    return [s for s in run.spans if s.name == name and s.trace_id == 0
            and s.parent_id is None and run.in_window(s.start)
            and s.end < cut]


def child_seconds(run, parents: List, name: str) -> List[float]:
    """The durations of the children called ``name`` of ``parents``."""
    ids = {p.span_id for p in parents}
    return [s.end - s.start for s in run.spans
            if s.name == name and s.parent_id in ids and s.trace_id == 0]


def admit_attrs(run) -> List[Dict]:
    return [s.attrs or {} for s in steps(run, "engine.admit")]


def decode_steps(run) -> List:
    """Decode step spans of graph replays and eager steps: a capture step
    also captures, once a params tree."""
    return [s for s in steps(run, "engine.decode")
            if (s.attrs or {}).get("mode") != "capture"]


def ms_per_ktok(run, name: str):
    """Milliseconds of the admissions' children ``name`` per thousand
    dispatched tokens (each dispatch's prompts × its rung, the base of
    ``prefill_ms_per_ktok``)."""
    admits = steps(run, "engine.admit")
    tok = sum(a.attrs["prompts"] * a.attrs["rung"] for a in admits)
    if not tok:
        return None
    return 1e3 * sum(child_seconds(run, admits, name)) / (tok / 1e3)


def mean_ms(run, parents: List, name: str):
    secs = child_seconds(run, parents, name)
    return 1e3 * sum(secs) / len(secs) if secs else None
