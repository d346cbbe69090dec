"""The port's host substrate, ``repro_torch.core``: copies of
``tests/test_metrics.py`` (exact histogram and percentile math, counters,
labels, SLO accounting, the cross-stack report schema) and
``tests/test_batching.py`` (AIMD, quantile regression, queues; paper §4.3),
run against ``repro_torch.core.metrics`` and ``repro_torch.core.batching``
instead of ``repro.core``."""

import math

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro_torch.core.batching import (AIMDController, BatchQueue,
                                       FixedController,
                                       QuantileRegressionController, bucket)
from repro_torch.core.interfaces import Query
from repro_torch.core.metrics import (BATCH_SIZE, CACHE_HITS, CACHE_MISSES,
                                      LATENCY, QUERIES_COMPLETED,
                                      QUERIES_SUBMITTED, SCHEMA, SERVICE,
                                      SLO_VIOLATIONS, MetricsRegistry,
                                      StreamingHistogram, VirtualClock)


# ---------------------------------------------------------------------------
# StreamingHistogram — exact-value percentile math
# ---------------------------------------------------------------------------

def test_histogram_exact_stats():
    h = StreamingHistogram(1e-6, 1e4, 24)
    for v in (0.001, 0.002, 0.003, 0.004):
        h.observe(v)
    assert h.count == 4
    assert h.vmin == 0.001
    assert h.vmax == 0.004
    assert h.mean == pytest.approx(0.0025, rel=1e-12)
    assert h.summary()["sum"] == pytest.approx(0.010, rel=1e-12)


def test_histogram_percentile_is_bucket_midpoint():
    """Decade buckets (bpd=1), lo=1: values 2 and 3 land in bucket [1, 10),
    whose geometric midpoint is exactly sqrt(10)."""
    h = StreamingHistogram(1.0, 1e3, 1)
    h.observe(2.0)
    h.observe(3.0)
    assert h.percentile(50) == pytest.approx(math.sqrt(10.0), rel=1e-12)
    assert h.percentile(99) == pytest.approx(math.sqrt(10.0), rel=1e-12)


def test_histogram_rank_semantics():
    """100 observations, one per decade bucket of [1, 10) and [10, 100):
    p50 must sit in the first bucket, p99 in the second."""
    h = StreamingHistogram(1.0, 1e3, 1)
    for _ in range(98):
        h.observe(5.0)            # bucket [1, 10)
    for _ in range(2):
        h.observe(50.0)           # bucket [10, 100)
    assert h.percentile(50) == pytest.approx(math.sqrt(10.0), rel=1e-12)
    assert h.percentile(98) == pytest.approx(math.sqrt(10.0), rel=1e-12)
    assert h.percentile(99) == pytest.approx(math.sqrt(1000.0), rel=1e-12)


def test_histogram_percentile_order_insensitive():
    vals = [0.5, 3.0, 700.0, 0.51, 12.0, 1.0, 80.0]
    a = StreamingHistogram(1e-2, 1e4, 8)
    b = StreamingHistogram(1e-2, 1e4, 8)
    for v in vals:
        a.observe(v)
    for v in reversed(vals):
        b.observe(v)
    for p in (1, 25, 50, 75, 95, 99, 100):
        assert a.percentile(p) == b.percentile(p)


def test_histogram_under_overflow_clamp():
    h = StreamingHistogram(1e-3, 1e3, 4)
    h.observe(1e-9)
    assert h.percentile(50) == 1e-3          # underflow reports lo
    h2 = StreamingHistogram(1e-3, 1e3, 4)
    h2.observe(1e9)
    assert h2.percentile(50) == 1e3          # overflow reports hi
    assert h2.vmax == 1e9                    # true max still tracked exactly


def test_histogram_relative_error_bound():
    """A percentile is the geometric midpoint of its bucket, so relative
    error is bounded by the half-bucket growth factor g**0.5 - 1."""
    bpd = 24
    g_half = 10.0 ** (0.5 / bpd)
    h = StreamingHistogram(1e-6, 1e4, bpd)
    v = 0.0137
    h.observe(v)
    p = h.percentile(50)
    assert v / g_half <= p <= v * g_half


def test_histogram_empty():
    h = StreamingHistogram()
    assert math.isnan(h.percentile(99))
    # schema-stable: empty summaries keep the full key set (null stats)
    s = h.summary()
    assert s["count"] == 0
    assert set(s) == {"count", "sum", "mean", "min", "max",
                      "p50", "p95", "p99"}
    assert all(s[k] is None for k in s if k != "count")


# ---------------------------------------------------------------------------
# MetricsRegistry — counters, labels, SLO, duration, schema
# ---------------------------------------------------------------------------

def test_counters_and_labels():
    m = MetricsRegistry()
    m.inc(QUERIES_SUBMITTED)
    m.inc(QUERIES_SUBMITTED, 4)
    m.inc(QUERIES_SUBMITTED, 2, model="a")
    assert m.counter(QUERIES_SUBMITTED) == 5
    assert m.counter(QUERIES_SUBMITTED, model="a") == 2
    assert m.counter("nonexistent") == 0


def test_slo_violation_accounting():
    m = MetricsRegistry(slo=0.020)
    m.observe_latency(0.001)
    m.observe_latency(0.020)                  # exactly on the deadline: OK
    m.observe_latency(0.020 + 5e-13)          # float noise: still OK
    m.observe_latency(0.021)                  # violation
    assert m.counter(SLO_VIOLATIONS) == 1
    assert m.hist(LATENCY).count == 4


def test_duration_and_throughput():
    m = MetricsRegistry(slo=1.0)
    m.mark(10.0)
    m.inc(QUERIES_COMPLETED, 50)
    m.mark(15.0)
    m.mark(12.0)                              # out-of-order marks are fine
    assert m.duration == 5.0
    assert m.report("frontend")["throughput_qps"] == pytest.approx(10.0)


def test_throughput_null_on_degenerate_mark_span():
    # no marks: duration 0 — throughput must be null, not a fabricated
    # division result
    m = MetricsRegistry(slo=1.0)
    m.inc(QUERIES_COMPLETED, 5)
    rep = m.report("frontend")
    assert rep["duration_s"] == 0.0
    assert rep["throughput_qps"] is None
    # a single mark (zero-width span) is equally degenerate
    m2 = MetricsRegistry(slo=1.0)
    m2.mark(3.0)
    m2.inc(QUERIES_COMPLETED, 5)
    assert m2.report("frontend")["throughput_qps"] is None


def test_report_schema_and_cache_rates():
    m = MetricsRegistry(slo=0.02)
    m.inc(CACHE_HITS, 3)
    m.inc(CACHE_MISSES)
    m.observe(BATCH_SIZE, 4, model="m0")
    m.observe(SERVICE, 0.002, model="m0")
    rep = m.report("frontend")
    assert rep["schema"] == SCHEMA
    assert rep["cache"]["hit_rate"] == pytest.approx(0.75)
    assert set(rep["per_model"]) == {"m0"}
    assert rep["per_model"]["m0"]["batch_size"]["count"] == 1
    # canonical top-level keys — the cross-stack contract
    assert set(rep) == {"schema", "stack", "duration_s", "queries",
                        "throughput_qps", "latency_s", "slo", "admission",
                        "cache", "batch_size", "queue_depth", "stragglers",
                        "faults", "per_model"}
    assert set(rep["slo"]) == {"target_s", "violations", "rate", "attainment"}
    assert set(rep["admission"]) == {"shed", "degraded", "shed_rate"}
    # the faults section is schema-stable: present and all-zero on a run
    # with no fault plan attached (DESIGN.md §14)
    assert set(v for v in rep["faults"].values()) == {0}


def test_report_json_stable():
    m = MetricsRegistry(slo=0.02)
    m.observe_latency(0.003)
    m.inc(QUERIES_COMPLETED)
    assert m.report_json("frontend") == m.report_json("frontend")


def test_virtual_clock():
    c = VirtualClock(5.0)
    assert c() == 5.0
    c.advance(1.5)
    assert c() == 6.5
    with pytest.raises(AssertionError):
        c.advance(-1.0)


# ---------------------------------------------------------------------------
# adaptive batching (tests/test_batching.py)
# ---------------------------------------------------------------------------

def _run_to_convergence(ctrl, latency_fn, iters=400):
    for _ in range(iters):
        b = ctrl.max_batch_size
        ctrl.record(b, latency_fn(b))
    return ctrl.max_batch_size


def test_aimd_converges_to_slo_boundary():
    """latency = 1ms + 0.5ms*b, SLO 20ms -> optimum b = 38; AIMD oscillates
    in a one-backoff band around it."""
    ctrl = AIMDController(0.020, additive=2, backoff=0.9)
    lat = lambda n: 0.001 + 0.0005 * n
    b = _run_to_convergence(ctrl, lat)
    assert 34 <= b <= 40
    assert lat(int(b * 0.9)) <= 0.020       # one backoff puts it under SLO


def test_aimd_adapts_downward():
    """After convergence, a slowdown (paper: GC pause / replica change)
    drives the max batch size back down."""
    ctrl = AIMDController(0.020)
    _run_to_convergence(ctrl, lambda n: 0.001 + 0.0005 * n)
    b_fast = ctrl.max_batch_size
    b_slow = _run_to_convergence(ctrl, lambda n: 0.001 + 0.002 * n)
    assert b_slow < b_fast
    assert 0.001 + 0.002 * b_slow <= 0.020 * 1.15


def test_quantile_regression_close_to_aimd():
    """Fig 4: the two strategies find similar operating points."""
    lat = lambda n: 0.001 + 0.0005 * n
    a = _run_to_convergence(AIMDController(0.020), lat)
    q = QuantileRegressionController(0.020)
    rng = np.random.default_rng(0)
    for _ in range(600):
        b = max(1, int(rng.integers(1, max(2, q.max_batch_size + 4))))
        q.record(b, lat(b) * (1 + abs(rng.normal(0, 0.02))))
    assert abs(q.max_batch_size - a) <= max(8, int(0.35 * a))


@given(st.integers(1, 5000))
def test_bucket_pow2(n):
    b = bucket(n)
    assert b >= n
    assert b < 2 * n or b == 1
    assert b & (b - 1) == 0 or n > 4096


@given(st.floats(0.002, 0.1), st.floats(1e-5, 1e-3), st.floats(1e-6, 1e-4))
@settings(max_examples=40, deadline=None)
def test_aimd_never_exceeds_slo_steady_state(slo, base, per_item):
    """Property: once converged, latency at the chosen batch size is within
    one backoff step of the SLO for any linear latency profile."""
    ctrl = AIMDController(slo, additive=1, backoff=0.9)
    lat = lambda n: base + per_item * n
    b = _run_to_convergence(ctrl, lat, iters=800)
    if lat(1) > slo:            # SLO unattainable: pinned at 1
        assert b == 1
    else:
        assert lat(max(1, int(b * 0.9) - 1)) <= slo * 1.05


def test_batch_queue_delay_and_admission():
    ctrl = FixedController(4)
    q = BatchQueue(ctrl, batch_delay=0.002)
    q.put(Query(0, None, arrival_time=0.0))
    assert not q.ready(0.001)            # delaying for more arrivals
    assert q.ready(0.0025)               # delay elapsed
    for i in range(1, 5):
        q.put(Query(i, None, arrival_time=0.001))
    assert q.ready(0.001)                # full batch short-circuits the delay
    batch = q.next_batch(0.001)
    assert len(batch) == 4 and len(q) == 1
