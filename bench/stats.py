"""Percentiles and spreads the benchmark reports."""

from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def percentile(vals: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear between ranks."""
    return float(np.percentile(np.asarray(vals, dtype=np.float64), q))


def spread(vals: Sequence[float]) -> float:
    """Distance between the first and third quartiles, as Python's
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q = statistics.quantiles(vals, n=4)
    return (q[2] - q[0]) / statistics.median(vals)
