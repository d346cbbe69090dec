"""The engine's step spans (``repro_torch/obs/tracer.py``): ``LMServer``
records each
prefill dispatch as an ``engine.admit`` span (children ``engine.prefill.
issue``, ``engine.prefill.wait``, ``engine.place``) and each decode step as
an ``engine.decode`` span (``engine.decode.launch``, ``engine.decode.wait``),
outside every request's trace, into the port's tracer built with
``engine=True``. Under ``torch.profiler`` each is also a range of its name
on the profiler's timeline. A tiny model on the CPU, no JAX but the
reference's ``Tracer`` class."""

import json

import numpy as np
import pytest
import torch

from repro_torch.core.batching import AIMDController
from repro_torch.core.metrics import VirtualClock
from repro_torch.metrics.validate import validate_trace
from repro_torch.models.api import build_model
from repro_torch.obs.export import chrome_trace
from repro_torch.obs.tracer import Tracer
from repro_torch.serving.engine import LMServer
from repro_torch.workloads.scenario import lm_config, seeded_params

ADMIT = ("engine.prefill.issue", "engine.prefill.wait", "engine.place")
DECODE = ("engine.decode.launch", "engine.decode.wait")
# a range opens a few microseconds after its span's clock reading, and
# closes a few after the closing one: their durations agree to this
RANGE_TOL_S = 2e-3


@pytest.fixture(scope="module")
def lm():
    cfg = lm_config()
    return build_model(cfg, device="cpu"), seeded_params(cfg, 0, "cpu")


def _service_model(kind, batch, tokens):
    return (0.004 + 5e-5 * batch * tokens if kind == "prefill"
            else 0.001 + 5e-5 * batch)


def _server(lm, tracer, *, slots=4, budget=None, virtual=False, **kw):
    model, _ = lm
    if virtual:
        kw.update(clock=VirtualClock(), service_model=_service_model)
    srv = LMServer(model, device="cpu", slots=slots, max_len=64,
                   temperature=0.0, tracer=tracer, **kw)
    if budget is not None:
        srv.admission = AIMDController(srv.admission.slo, additive=1,
                                       init=budget,
                                       max_batch=max(slots, budget))
    return srv


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(n)).astype(np.int32)
            for n in lengths]


def _serve(lm, tracer, lengths=(5, 9, 17, 3, 12, 30, 7, 21, 4), *,
           max_new=5, **kw):
    srv = _server(lm, tracer, **kw)
    for p in _prompts(lengths):
        srv.submit(p, max_new_tokens=max_new)
    srv.run(lm[1])
    return srv


def _steps(tracer, name=None):
    return [s for s in tracer.spans() if s.name.startswith("engine.")
            and (name is None or s.name == name)]


def _children(tracer, parent):
    return [s for s in tracer.spans() if s.parent_id == parent.span_id
            and s.trace_id == 0]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "reference"])
def test_one_span_a_dispatch_and_a_decode_step(lm, fused):
    tr = Tracer()
    srv = _serve(lm, tr, fused=fused, budget=2)
    admits, decodes = _steps(tr, "engine.admit"), _steps(tr, "engine.decode")
    assert len(admits) == srv.stats["prefill_dispatches"] > 1
    assert len(decodes) == srv.stats["decode_steps"] > 1
    for a in admits:
        assert [c.name for c in _children(tr, a)] == list(ADMIT)
    for d in decodes:
        assert [c.name for c in _children(tr, d)] == list(DECODE)
        assert d.attrs["mode"] == "eager"
        assert 1 <= d.attrs["active"] <= srv.slots
    assert sum(d.attrs["active"] for d in decodes) == sum(
        len(r.tokens) - 1 for r in srv.completed.values())


@pytest.mark.parametrize("fused,pad", [(True, None), (True, False),
                                       (False, None)],
                         ids=["ladder", "exact", "reference"])
def test_cpu_prefill_runs_eagerly(lm, fused, pad):
    """On the CPU no prefill runs from a CUDA graph, on the ladder or off
    it: every ``engine.admit`` span's ``mode`` is "eager", the graph
    counters in ``stats`` stay 0 and ``engine.prefill.graph`` is false."""
    tr = Tracer()
    srv = _serve(lm, tr, (5, 9, 5, 9, 17, 5, 9, 17, 5), budget=2,
                 fused=fused, pad_prompts=pad)
    admits = _steps(tr, "engine.admit")
    assert len(admits) == srv.stats["prefill_dispatches"] > 3
    assert {a.attrs["padded"] for a in admits} == {pad is None and fused}
    assert [a.attrs["mode"] for a in admits] == ["eager"] * len(admits)
    assert srv.stats["prefill_graph_captures"] == 0
    assert srv.stats["prefill_graph_replays"] == 0
    assert srv.engine_report()["prefill"]["graph"] is False


@pytest.mark.parametrize("virtual", [False, True], ids=["wall", "virtual"])
def test_children_inside_their_parent_in_order(lm, virtual):
    tr = Tracer()
    _serve(lm, tr, budget=2, virtual=virtual)
    parents = _steps(tr, "engine.admit") + _steps(tr, "engine.decode")
    for p in parents:
        kids = _children(tr, p)
        assert p.start <= kids[0].start
        for a, b in zip(kids, kids[1:]):
            assert a.start <= a.end <= b.start <= b.end
        assert kids[-1].end <= p.end
        assert all(k.kind == "span" and k.trace_id == 0 for k in kids)


def test_issue_and_wait_partition_the_requests_prefill(lm):
    """Under a virtual clock the service model's time is the wait; on any
    clock issue + wait is the dispatch's ``lm.prefill`` span."""
    tr = Tracer()
    _serve(lm, tr, budget=3, virtual=True)
    prefill = {(s.start, s.end) for s in tr.spans()
               if s.component == "lm.prefill"}
    got = set()
    for a in _steps(tr, "engine.admit"):
        issue, wait, _ = _children(tr, a)
        assert issue.end == issue.start        # the clock stands still
        assert wait.start == issue.end
        got.add((issue.start, wait.end))
    assert got == prefill


def test_admitted_prompts_and_tokens_add_up(lm):
    tr = Tracer()
    lengths = (5, 9, 17, 3, 12, 30, 7, 21, 4)
    srv = _serve(lm, tr, lengths, budget=3)
    admits = [a.attrs for a in _steps(tr, "engine.admit")]
    assert sum(a["prompts"] for a in admits) == len(lengths) == len(
        srv.completed)
    assert sum(a["tokens_valid"] for a in admits) == sum(lengths)
    for a in admits:
        assert a["tokens_padded"] == a["rows"] * a["rung"]
        assert a["tokens_padded"] >= a["tokens_valid"]
        assert a["rows"] >= a["prompts"] and a["padded"] is True
        assert a["prompts"] <= min(a["free"], a["queued"], a["budget"])
    assert sorted(srv.rung_dispatches.items()) == sorted(
        (r, sum(a["rung"] == r for a in admits))
        for r in {a["rung"] for a in admits})


@pytest.mark.parametrize("cap,lengths,budget,pad", [
    ("slots", (5, 9, 17, 3, 12, 30), 6, None),
    ("slots+budget", (5, 9, 17, 3, 12, 30), 4, None),
    ("slots+queue", (5, 9, 17, 3), 6, None),
    ("slots+budget+queue", (5, 9, 17, 3), 4, None),
    ("budget", (5, 9, 17), 1, None),
    ("budget+queue", (5, 9), 2, None),
    ("queue", (5, 9), 4, None),
    ("length", (5, 7, 5), 4, False),
])
def test_limit_names_what_capped_the_dispatch(lm, cap, lengths, budget, pad):
    """The first admission of the queued ``lengths``: four free slots, the
    AIMD budget ``budget``; every bound the dispatch reached is named, so
    "slots" alone means the free slots capped it below the budget and the
    queue; the exact path (``pad`` False) takes the same-length group at
    the queue's head."""
    tr = Tracer()
    srv = _server(lm, tr, budget=budget, pad_prompts=pad)
    for p in _prompts(lengths):
        srv.submit(p, max_new_tokens=3)
    srv._admit(lm[1])
    (admit,) = _steps(tr, "engine.admit")
    a = admit.attrs
    assert a["limit"] == cap
    assert (a["free"], a["queued"], a["budget"]) == (4, len(lengths),
                                                     budget)
    n = min(4, len(lengths), budget) if pad is None else 2
    assert a["prompts"] == n and srv.stats["prefill_dispatches"] == 1
    assert a["padded"] is (pad is None)


def test_no_step_span_without_the_engine_flag(lm):
    from repro.obs.tracer import Tracer as JTracer
    for tr in (Tracer(engine=False), JTracer()):
        srv = _serve(lm, tr)
        assert srv._steps is None
        assert not [s for s in tr.spans() if s.name.startswith("engine.")]
        # what remains outside the requests is the compile events
        assert {s.name for s in tr.spans() if s.trace_id == 0} == {
            "compile"}


def test_step_spans_evict_no_request_span(lm):
    """Step spans keep a ring of their own: with both rings wrapped, the
    requests' ring holds what it holds without step spans, and
    ``summary()`` counts both rings' drops."""
    tracers = {}
    for engine in (False, True):
        tracers[engine] = tr = Tracer(capacity=16, engine=engine)
        _serve(lm, tr, budget=2, virtual=True)
    off, on = tracers[False], tracers[True]

    def key(s):
        return (s.trace_id, s.name, s.component, s.kind, s.start, s.end)
    assert [key(s) for s in on.log.spans()] == [
        key(s) for s in off.log.spans()]
    assert off.log.dropped > 0 and len(off.step_log) == 0
    assert on.step_log.dropped > 0 and len(on.step_log) == 16
    assert all(s.trace_id == 0 and s.name.startswith("engine.")
               for s in on.step_log.spans())
    summary = on.summary()
    assert summary["dropped"] == off.log.dropped + on.step_log.dropped
    assert summary["spans"] == 32 and summary["capacity"] == 16
    assert off.summary()["dropped"] == off.log.dropped


def test_step_spans_sit_under_no_request(lm):
    tr = Tracer(sample_rate=0.5, seed=3)
    srv = _serve(lm, tr)
    steps = _steps(tr)
    assert steps and all(s.trace_id == 0 for s in steps)
    ids = {s.span_id for s in steps}
    assert all(s.parent_id is None or s.parent_id in ids for s in steps)
    assert not [s for s in tr.spans() if s.trace_id != 0
                and s.name.startswith("engine.")]
    # they ignore the sample rate, and are neither traces nor attributed
    assert len(_steps(tr, "engine.decode")) == srv.stats["decode_steps"]
    assert tr.traces == 9 and tr.sampled < 9
    assert tr.attribution_report()["queries"] == tr.sampled
    untraced = Tracer(sample_rate=0.0)
    srv = _serve(lm, untraced)
    assert untraced.sampled == 0
    assert {s.trace_id for s in untraced.spans()} == {0}
    assert len(_steps(untraced, "engine.admit")) == srv.stats[
        "prefill_dispatches"]


def test_step_spans_byte_identical_per_seed(lm):
    docs = []
    for _ in range(2):
        tr = Tracer(seed=5)
        _serve(lm, tr, budget=2, virtual=True, seed=5)
        docs.append(json.dumps([s.to_dict() for s in _steps(tr)],
                               sort_keys=True))
    assert docs[0] == docs[1]
    assert len(json.loads(docs[0])) > 10


def test_step_spans_export_as_nested_events_on_lane_zero(lm):
    tr = Tracer()
    _serve(lm, tr, budget=2, virtual=True)
    doc = json.loads(tr.to_json())
    assert validate_trace(doc) == []
    events = [e for e in chrome_trace(doc)["traceEvents"]
              if e["name"].startswith("engine.")]
    spans = [s for s in doc["spans"] if s["name"].startswith("engine.")]
    assert len(events) == len(spans) == len(_steps(tr))
    assert all(e["ph"] == "X" and e["tid"] == 0 for e in events)
    by_id = {s["span_id"]: e for s, e in zip(spans, events)}
    for s, e in zip(spans, events):
        assert e["name"] == s["name"] and e["args"] == s["attrs"]
        if s["parent_id"] is not None:
            p = by_id[s["parent_id"]]
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-6
    admit = next(e for e in events if e["name"] == "engine.admit")
    assert {"prompts", "rows", "rung", "limit"} <= set(admit["args"])


def _ranges(prof):
    return [e for e in prof.events() if e.name.startswith("engine.")]


def test_step_spans_are_profiler_ranges(lm):
    """One range a span, of its name, nested as the spans are, lasting as
    long within ``RANGE_TOL_S``; none without a profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):   # the first range's own set-up
            pass
        _serve(lm, tr, budget=2)
    spans = sorted(_steps(tr), key=lambda s: (s.start, s.span_id))
    ranges = _ranges(prof)
    assert sorted(r.name for r in ranges) == sorted(s.name for s in spans)
    assert all(s.range is None for s in spans)
    for r in ranges:
        parent = r.cpu_parent
        while parent is not None and not parent.name.startswith("engine."):
            parent = parent.cpu_parent
        want = {"engine.prefill.issue": "engine.admit",
                "engine.prefill.wait": "engine.admit",
                "engine.place": "engine.admit",
                "engine.decode.launch": "engine.decode",
                "engine.decode.wait": "engine.decode"}.get(r.name)
        assert (parent.name if parent is not None else None) == want
    for name in {s.name for s in spans}:
        mine = [s for s in spans if s.name == name]
        theirs = sorted((r for r in ranges if r.name == name),
                        key=lambda r: r.time_range.start)
        for s, r in zip(mine, theirs):
            dur = (r.time_range.end - r.time_range.start) / 1e6
            assert abs(dur - (s.end - s.start)) <= RANGE_TOL_S, name


def test_no_range_without_a_profiler(lm, monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name} opened without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tr = Tracer()
    _serve(lm, tr)
    assert _steps(tr) and all(s.range is None for s in _steps(tr))
