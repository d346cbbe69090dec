"""The readers of the engine's step spans (``bench/steps.py``): their
arithmetic by hand on made-up spans, the profiled span left out, nothing
read from a program without step spans, and a number from each in a tiny
traced run of each cell on the CPU."""

import time

import pytest
import torch

import _tiny
from bench import harness
from repro_torch.obs.tracer import Span

NEW = ("prefill_issue_ms_per_ktok", "prefill_wait_ms_per_ktok",
       "admit_place_ms", "decode_launch_ms", "decode_wait_ms",
       "prefill_pad_share", "prefill_slot_bound_share")


def read(name, run):
    return harness.reader("metrics", name)(run)


class _Spans:
    """Step spans as the engine records them, with made-up times."""

    def __init__(self):
        self.spans, self._id = [], 0

    def _add(self, name, start, end, parent=None, attrs=None):
        self._id += 1
        s = Span(self._id, 0, parent.span_id if parent else None, name,
                 "engine", start, end, attrs=attrs)
        self.spans.append(s)
        return s

    def admit(self, t, issue, wait, place, *, prompts, rung, rows, valid,
              limit):
        a = self._add("engine.admit", t, t + issue + wait + place + 1e-4,
                      attrs=dict(prompts=prompts, rows=rows, rung=rung,
                                 padded=True, tokens_valid=valid,
                                 tokens_padded=rows * rung, limit=limit))
        self._add("engine.prefill.issue", t, t + issue, a)
        self._add("engine.prefill.wait", t + issue, t + issue + wait, a)
        self._add("engine.place", t + issue + wait,
                  t + issue + wait + place, a)

    def decode(self, t, launch, wait, mode="replay"):
        d = self._add("engine.decode", t, t + launch + wait + 1e-4,
                      attrs=dict(active=3, mode=mode))
        self._add("engine.decode.launch", t, t + launch, d)
        self._add("engine.decode.wait", t + launch, t + launch + wait, d)


def _run(spans, profiled=None):
    return harness.Run(ws=10.0, end=20.0, spans=spans, profiled=profiled)


def _made_up():
    s = _Spans()
    s.admit(9.0, 0.5, 0.5, 0.5, prompts=4, rung=1024, rows=4, valid=3000,
            limit="slots")                        # before the window
    s.admit(11.0, 0.030, 0.010, 0.002, prompts=1, rung=1024, rows=1,
            valid=700, limit="slots")
    s.admit(12.0, 0.050, 0.030, 0.004, prompts=2, rung=512, rows=2,
            valid=900, limit="budget")
    s.admit(12.5, 0.020, 0.010, 0.003, prompts=2, rung=1024, rows=2,
            valid=1500, limit="slots+budget")     # a tie: not slots alone
    s.decode(13.0, 0.9, 0.9, mode="capture")      # captures: left out
    s.decode(13.5, 0.002, 0.018)
    s.decode(14.0, 0.004, 0.016, mode="eager")
    return s.spans


def test_readers_by_hand():
    run = _run(_made_up())
    tok = 1 * 1024 + 2 * 512 + 2 * 1024
    assert read("prefill_issue_ms_per_ktok", run) == pytest.approx(
        1e3 * 0.100 / (tok / 1e3))
    assert read("prefill_wait_ms_per_ktok", run) == pytest.approx(
        1e3 * 0.050 / (tok / 1e3))
    assert read("admit_place_ms", run) == pytest.approx(3.0)
    assert read("decode_launch_ms", run) == pytest.approx(3.0)
    assert read("decode_wait_ms", run) == pytest.approx(17.0)
    assert read("prefill_pad_share", run) == pytest.approx(
        100 * (4096 - 3100) / 4096)
    assert read("prefill_slot_bound_share", run) == pytest.approx(100 / 3)


@pytest.mark.parametrize("name", NEW)
def test_step_readers_leave_out_the_profiled_span(name):
    """A step inside the profiled span, which the profiler slows, changes
    none of the readings."""
    base = read(name, _run(_made_up()))
    spans = _Spans()
    spans.admit(18.0, 0.3, 0.3, 0.3, prompts=8, rung=128, rows=8,
                valid=100, limit="queue")
    spans.decode(18.5, 0.2, 0.2)
    slow = _made_up() + spans.spans
    assert base is not None
    assert read(name, _run(slow, profiled=(17.0, 20.0))) == pytest.approx(
        base)
    assert read(name, _run(slow)) != pytest.approx(base)


@pytest.mark.parametrize("name", NEW)
def test_no_step_spans_read_nothing(name):
    """A program whose tracer records no step spans (the request spans and
    compile events only) gives no reading."""
    spans = [Span(1, 0, None, "compile", "engine.prefill", 11.0, 11.0,
                  kind="event"),
             Span(2, 1, None, "request", "lm", 11.0, 12.0),
             Span(3, 1, 2, "prefill", "lm.prefill", 11.1, 11.2,
                  attrs={"batch": 1, "padded_len": 1024})]
    assert read(name, _run(spans)) is None
    assert read(name, _run([])) is None


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["hymba-1.5b.docqa1k", "dbrx-132b.batch"])
def test_tiny_traced_run_reads_every_step_metric(cell, one_thread):
    out = harness.run_cell(cell, 2 ** 32 + 29, 2.5, True,
                           t_process=time.perf_counter(), device="cpu",
                           overrides=_tiny.overrides(cell))
    want = {m["name"] for m in harness.manifest()["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}
    assert want and want <= set(out["metrics"]), out["metrics"]
    m = {k: out["metrics"][k]["value"] for k in want}
    assert all(v >= 0 for v in m.values()), m
    if "prefill_pad_share" in m:
        assert 0 < m["prefill_pad_share"] < 100
        assert 0 <= m["prefill_slot_bound_share"] <= 100
