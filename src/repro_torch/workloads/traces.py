"""Open-loop arrival-trace generators (paper §6 methodology).

Clipper's latency/throughput curves are measured under *open-loop* load:
arrivals come from a stochastic process, not from request/response
round-trips, so queueing delay is visible instead of self-throttled. Four
arrival processes cover the evaluation space:

* ``poisson_trace``       — homogeneous Poisson (Fig 4 steady state)
* ``bursty_trace``        — 2-state Markov-modulated Poisson (burst/lull)
* ``diurnal_trace``       — sinusoidal rate ramp (day/night cycle)
* ``flash_crowd_trace``   — baseline plus a rate spike window

All are deterministic functions of their seed. Inhomogeneous processes use
Lewis-Shedler thinning: candidates at the peak rate, accepted with
probability rate(t)/peak — exact and reproducible.

``query_trace`` attaches query payloads drawn from a finite pool with a
Zipf popularity skew, the regime where the prediction cache (paper §4.2)
matters; ``pool=0`` makes every query unique (cache-defeating).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def poisson_trace(rate: float, duration: float, seed: int = 0,
                  start: float = 0.0) -> np.ndarray:
    """Arrival times of a homogeneous Poisson process on [start, start+duration)."""
    assert rate > 0 and duration > 0
    rng = np.random.default_rng(seed)
    # draw in chunks: E[n] + 6 sigma covers the tail, top up if short
    expected = rate * duration
    chunk = max(16, int(expected + 6.0 * np.sqrt(expected)))
    times: List[float] = []
    t = start
    end = start + duration
    while t < end:
        gaps = rng.exponential(1.0 / rate, size=chunk)
        for g in gaps:
            t += g
            if t >= end:
                break
            times.append(t)
        else:
            continue
        break
    return np.asarray(times, dtype=np.float64)


def bursty_trace(rate_low: float, rate_high: float, duration: float,
                 seed: int = 0, *, mean_dwell_low: float = 0.5,
                 mean_dwell_high: float = 0.1,
                 start: float = 0.0) -> np.ndarray:
    """2-state Markov-modulated Poisson process: exponential dwell times
    alternate between a lull (``rate_low``) and a burst (``rate_high``)."""
    assert 0 < rate_low <= rate_high and duration > 0
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = start
    end = start + duration
    high = False
    while t < end:
        dwell = rng.exponential(mean_dwell_high if high else mean_dwell_low)
        seg_end = min(t + dwell, end)
        rate = rate_high if high else rate_low
        u = t
        while True:
            u += rng.exponential(1.0 / rate)
            if u >= seg_end:
                break
            times.append(u)
        t = seg_end
        high = not high
    return np.asarray(times, dtype=np.float64)


def _thinned(peak: float, rate_at, duration: float, seed: int,
             start: float) -> np.ndarray:
    """Lewis-Shedler thinning of a peak-rate Poisson process."""
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = start
    end = start + duration
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= end:
            break
        if rng.random() < rate_at(t - start) / peak:
            times.append(t)
    return np.asarray(times, dtype=np.float64)


def diurnal_trace(rate_min: float, rate_max: float, duration: float,
                  seed: int = 0, *, period: float = None,
                  start: float = 0.0) -> np.ndarray:
    """Sinusoidal rate ramp between ``rate_min`` and ``rate_max`` (one full
    cycle over ``period``, default the whole trace) — the day/night profile
    autoscaling papers (InferLine) evaluate against."""
    assert 0 < rate_min <= rate_max and duration > 0
    period = duration if period is None else period
    mid = (rate_min + rate_max) / 2.0
    amp = (rate_max - rate_min) / 2.0

    def rate_at(t: float) -> float:
        return mid - amp * np.cos(2.0 * np.pi * t / period)

    return _thinned(rate_max, rate_at, duration, seed, start)


def flash_crowd_trace(base_rate: float, spike_rate: float, duration: float,
                      seed: int = 0, *, spike_start: float = None,
                      spike_duration: float = None,
                      start: float = 0.0) -> np.ndarray:
    """Baseline Poisson load with a flash-crowd window at ``spike_rate``
    (default: the middle fifth of the trace)."""
    assert 0 < base_rate <= spike_rate and duration > 0
    spike_start = 0.4 * duration if spike_start is None else spike_start
    spike_duration = (0.2 * duration if spike_duration is None
                      else spike_duration)

    def rate_at(t: float) -> float:
        in_spike = spike_start <= t < spike_start + spike_duration
        return spike_rate if in_spike else base_rate

    return _thinned(spike_rate, rate_at, duration, seed, start)


def query_trace(times: np.ndarray, seed: int = 0, *, d_feat: int = 64,
                pool: int = 0, zipf_a: float = 1.2,
                contexts: int = 1) -> List[Tuple[float, np.ndarray, int]]:
    """Attach payloads to arrival times: ``pool > 0`` draws queries from a
    fixed pool with Zipf(a) popularity (cache-friendly); ``pool = 0`` makes
    every query unique. Returns the frontend's replay format
    ``[(arrival_time, x, context_id)]``."""
    rng = np.random.default_rng(seed)
    n = len(times)
    ctx = (rng.integers(0, contexts, size=n) if contexts > 1
           else np.zeros(n, dtype=np.int64))
    if pool > 0:
        bank = rng.normal(size=(pool, d_feat)).astype(np.float32)
        ranks = np.arange(1, pool + 1, dtype=np.float64) ** (-zipf_a)
        probs = ranks / ranks.sum()
        idx = rng.choice(pool, size=n, p=probs)
        xs = [bank[i] for i in idx]
    else:
        xs = list(rng.normal(size=(n, d_feat)).astype(np.float32))
    return [(float(t), x, int(c)) for t, x, c in zip(times, xs, ctx)]
