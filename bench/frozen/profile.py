"""Interval arithmetic over a device trace, frozen for the benchmark.

``union_us`` is ``_union_us`` of ``chip_smoke.py`` at commit 1c513d0,
unchanged."""

from __future__ import annotations


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total
