"""The port's workloads and its quickstart against the JAX package.

``repro_torch.workloads.traces`` is a copy of ``repro.workloads.traces``:
every generator must give the same trace, byte for byte, for the same
arguments and seed. ``examples/quickstart_torch.py --device cpu`` serves the
reference quickstart's reduced config: every request completes with its 24
tokens, one host copy per decode step."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.configs.registry import ARCHITECTURES, reduced_config
from repro.workloads import traces as jtraces
from repro_torch import workloads
from repro_torch.workloads import traces as ttraces

ROOT = Path(__file__).resolve().parents[1]

# (generator, positional args, keyword args): each with its defaults and
# with its options set
GENERATORS = [
    ("poisson_trace", (200.0, 1.5), {}),
    ("poisson_trace", (50.0, 2.0), {"start": 3.25}),
    ("bursty_trace", (20.0, 400.0, 2.0), {}),
    ("bursty_trace", (5.0, 80.0, 3.0),
     {"mean_dwell_low": 0.2, "mean_dwell_high": 0.05, "start": 1.0}),
    ("diurnal_trace", (10.0, 300.0, 2.0), {}),
    ("diurnal_trace", (1.0, 50.0, 4.0), {"period": 1.5, "start": 0.5}),
    ("flash_crowd_trace", (30.0, 600.0, 2.0), {}),
    ("flash_crowd_trace", (30.0, 600.0, 2.0),
     {"spike_start": 0.25, "spike_duration": 0.5, "start": 2.0}),
]


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("gen", GENERATORS,
                         ids=[f"{g[0]}-{i}" for i, g in enumerate(GENERATORS)])
def test_arrival_traces_byte_equal(gen, seed):
    name, args, kw = gen
    want = getattr(jtraces, name)(*args, seed=seed, **kw)
    got = getattr(ttraces, name)(*args, seed=seed, **kw)
    assert len(want) > 0
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("kw", [{}, {"pool": 16, "contexts": 3},
                                {"d_feat": 8, "pool": 5, "zipf_a": 2.0}])
def test_query_trace_byte_equal(kw, seed):
    times = jtraces.poisson_trace(100.0, 1.0, seed=seed)
    want = jtraces.query_trace(times, seed, **kw)
    got = ttraces.query_trace(times, seed, **kw)
    assert len(got) == len(want) == len(times)
    for (tg, xg, cg), (tw, xw, cw) in zip(got, want):
        assert (tg, cg) == (tw, cw)
        assert xg.dtype == xw.dtype and xg.tobytes() == xw.tobytes()


def test_workloads_package_exports_only_the_traces():
    assert sorted(workloads.__all__) == sorted(
        ["poisson_trace", "bursty_trace", "diurnal_trace",
         "flash_crowd_trace", "query_trace"])
    for name in workloads.__all__:
        assert getattr(workloads, name) is getattr(ttraces, name)


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_cpu(capsys):
    """24 requests of 16 tokens, 24 new tokens each, through the reference
    quickstart's reduced smollm (its config field for field), on the CPU:
    all complete with 24 tokens, one host sync per decode step, and the
    reference's telemetry line."""
    srv = _quickstart().main(["--device", "cpu"])
    out = capsys.readouterr().out
    want = reduced_config(ARCHITECTURES["smollm-360m"], num_layers=4,
                          d_model=128)
    assert dataclasses.asdict(srv.model.cfg) == dataclasses.asdict(want)
    assert len(srv.completed) == 24
    assert all(len(r.tokens) == 24 for r in srv.completed.values())
    assert all(len(r.prompt) == 16 for r in srv.completed.values())
    assert srv.stats["host_syncs_per_decode_step"] == 1.0
    assert srv.engine_report()["decode"]["graph"] is False
    assert srv.temperature == 0.8 and srv.slots == 8
    tokens = np.concatenate([r.tokens for r in srv.completed.values()])
    assert 0 <= tokens.min() and tokens.max() < want.vocab_size
    assert "telemetry: p50=" in out and "mean_batch=" in out
