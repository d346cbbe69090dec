"""``prefill_graph_share``, the share of the program's ``engine.admit``
spans whose ``mode`` is "replay": its arithmetic by hand on made-up
spans, the profiled span left out, nothing read from a program whose
admission spans carry no ``mode``, and 0 in a tiny traced run of each cell
on the CPU, where every prefill runs eagerly."""

import time

import pytest
import torch

import _tiny
from bench import harness
from repro_torch.obs.tracer import Span


def read(run):
    return harness.reader("metrics", "prefill_graph_share")(run)


def _admits(modes, t0=11.0):
    """One ``engine.admit`` step span a mode (None: no ``mode``), 0.1 s
    apart from ``t0``, each with an issue child."""
    spans = []
    for i, mode in enumerate(modes):
        t = t0 + 0.1 * i
        attrs = dict(prompts=1, rows=1, rung=1024, padded=True,
                     tokens_valid=700, tokens_padded=1024, limit="slots")
        if mode is not None:
            attrs["mode"] = mode
        a = Span(2 * i + 1, 0, None, "engine.admit", "engine", t, t + 0.05,
                 attrs=attrs)
        spans += [a, Span(2 * i + 2, 0, a.span_id, "engine.prefill.issue",
                          "engine", t, t + 0.01)]
    return spans


def _run(spans, profiled=None):
    return harness.Run(ws=10.0, end=20.0, spans=spans, profiled=profiled)


def test_share_by_hand():
    before = _admits(["eager", "eager"], t0=9.0)        # before the window
    inside = _admits(["eager", "capture", "replay", "replay", "replay"])
    assert read(_run(before + inside)) == pytest.approx(60.0)
    assert read(_run(_admits(["eager"] * 3))) == 0.0
    assert read(_run(_admits(["replay"] * 4))) == 100.0


def test_profiled_span_left_out():
    spans = _admits(["eager", "replay"]) + _admits(["eager"] * 4, t0=18.0)
    assert read(_run(spans)) == pytest.approx(100 / 6)
    assert read(_run(spans, profiled=(17.0, 20.0))) == pytest.approx(50.0)


def test_admissions_without_mode_read_nothing():
    """A program whose admissions carry no ``mode`` (one that graphs no
    prefill), or that records no step spans, gives no reading."""
    assert read(_run(_admits([None, None, None]))) is None
    assert read(_run([Span(1, 1, None, "request", "lm", 11.0, 12.0)])) is None
    assert read(_run([])) is None


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["hymba-1.5b.docqa1k", "dbrx-132b.batch"])
def test_tiny_traced_run_reads_no_replay_on_the_cpu(cell, one_thread):
    out = harness.run_cell(cell, 2 ** 32 + 31, 2.5, True,
                           t_process=time.perf_counter(), device="cpu",
                           overrides=_tiny.overrides(cell))
    assert out["metrics"]["prefill_graph_share"] == {"value": 0.0,
                                                     "unit": "%"}
