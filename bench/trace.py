"""The reduction of one ``torch.profiler`` span of a traced run.

Device operations (kernels, copies, memsets) and the harness's labels on
the host (``bench.admit`` around each admission call, ``bench.decode``
around each decode call; ``bench/harness.py``) are read from the
profiler's raw events. Busy time is the union of device-operation
intervals (``bench/frozen/profile.py``); the idle gaps are the holes in
that union, each named by what the host was doing at its middle: the
harness's label and the innermost host operation under it."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

from bench.frozen.profile import union_us

LABELS = ("bench.admit", "bench.decode")


def _events(prof):
    """(device ops, host ops) as lists of (name, start_us, end_us)."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if t < s:
            t = s + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            # the harness's own labels, mirrored on the device's timeline,
            # are no device work
            if e.name() not in LABELS and not e.is_user_annotation():
                dev.append((e.name(), s, t))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), s, t))
    return dev, host


def clip_union(ops: Iterable[Tuple[str, float, float]],
               spans: List[Tuple[float, float]]) -> float:
    """Microseconds of the union of ``ops``' intervals inside ``spans``."""
    iv = []
    spans = sorted(spans)
    opsl = sorted((s, t) for _, s, t in ops)
    j = 0
    for lo, hi in spans:
        while j < len(opsl) and opsl[j][1] < lo:
            j += 1
        k = j
        while k < len(opsl) and opsl[k][0] <= hi:
            s, t = opsl[k]
            if t > lo and s < hi:
                iv.append((max(s, lo), min(t, hi)))
            k += 1
    return union_us(iv)


def _merged(ops) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, t in sorted((s, t) for _, s, t in ops):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(a, b) for a, b in out]


def _host_at(host, labels, t: float) -> str:
    """The harness label and the innermost host operation at ``t``."""
    lab = next((n for n, s, e in labels if s <= t <= e), "bench.loop")
    inner, width = None, float("inf")
    for n, s, e in host:
        if s <= t <= e and n not in LABELS and e - s < width:
            inner, width = n, e - s
    return lab if inner is None else f"{lab} > {inner}"


def reduce(prof, t_start: float, t_stop: float) -> Dict:
    """Busy and window seconds, device time by operation, the labelled
    host intervals, and the breakdown the result line carries."""
    dev, host = _events(prof)
    labels = [(n, s, e) for n, s, e in host if n in LABELS]
    by_name: Dict[str, float] = defaultdict(float)
    for n, s, e in dev:
        by_name[n] += e - s
    merged = _merged(dev)
    gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
            for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    gaps.sort(reverse=True)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = union_us((s, e) for _, s, e in dev)
    return {
        "busy_s": busy / 1e6,
        "window_s": t_stop - t_start,
        "device": dev,
        "admits": [(s, e) for n, s, e in labels if n == "bench.admit"],
        "decodes": [(s, e) for n, s, e in labels if n == "bench.decode"],
        "breakdown": {
            "device_ops": [[n[:160], v / 1e6] for n, v in top_ops],
            "idle_gaps": [[_host_at(host, labels, mid)[:160], g / 1e6]
                          for g, mid in gaps[:10]],
        },
    }


def kernel_us(trace: Dict, names: Iterable[str], within=None) -> float:
    """Device microseconds of the kernels whose name holds one of
    ``names`` (the profiler's names are demangled: ``void name<...>(...)``),
    inside the host intervals ``within`` where given (by each kernel's
    start)."""
    names = tuple(names)
    spans = sorted(within) if within is not None else None
    starts = [lo for lo, _ in spans] if spans is not None else None
    total = 0.0
    hit: Dict[str, bool] = {}
    for n, s, e in trace["device"]:
        if n not in hit:
            hit[n] = any(k in n for k in names)
        if not hit[n]:
            continue
        if spans is not None:
            i = bisect.bisect_right(starts, s) - 1
            if i < 0 or s > spans[i][1]:
                continue
        total += e - s
    return total
