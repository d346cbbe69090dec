"""The port's four example twins (``examples/*_torch.py``) and their
helpers (``examples/common_torch.py``) against the reference examples and
``benchmarks/common.py``, on the CPU.

Each comparison runs the reference's ``main()`` or helper in this process,
loaded from its file, on the same seed, and the twin with ``--device cpu``:

* the cascade pipeline and the flash crowd run on a virtual clock, so the
  twin prints the reference's output byte for byte;
* the adaptive batching demo prints the reference's output byte for byte
  when both modules time a batch with the same deterministic function of
  its size (``_fake_time_batch``), which crosses the 20 ms SLO below the
  demo's largest batch, so AIMD backs off;
* the Fig 3 predictors hold bit-equal weights and agree to
  ``PRED_RTOL``; a trained linear model agrees to ``TRAIN_ATOL``, picks
  the same class on 1,000 seeded points and leaves the numpy generator
  where the reference leaves it;
* the ensemble's three phases agree in error rate within one query of 400
  (``ERR_QUERIES``), its Exp4 weights to ``WEIGHT_RTOL``, and every other
  line, the telemetry line among them, byte for byte."""

import importlib.util
import inspect
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("cascade_pipeline", "flash_crowd_autoscale",
         "adaptive_batching_demo", "ensemble_serving")

# a predictor's output, twin against reference: max |difference| within
# this share of the largest |output|. Both sum fp32 products (up to 2,048
# terms, then exp for the kernel SVM) in their own orders; seen up to
# 9.5e-7 on the CPU (kernel_svm, b = 64). TF32 inputs (10-bit mantissas)
# would move the products by about 2**-11 and fail it.
PRED_RTOL = 1e-5
# a trained model's class probabilities, twin against reference: 60 steps
# of full-batch gradient descent whose gradients sum 2,000 fp32 terms in
# other orders (seen up to 4.8e-7)
TRAIN_ATOL = 1e-5
# the ensemble, twin against reference: a phase's error count may differ
# by this many of its 400 queries, and each Exp4 weight by this share of
# itself; the weights are softmaxes of log-weights (down to the floor of
# -20) that 1,200 updates moved, each by the models' 0/1 losses, so they
# part only by fp32 roundings of those sums: one rounding of a log-weight
# of 20 moves its weight by 2e-6 of itself (seen: 0 queries, weights
# within 2.9e-6 of themselves on the CPU)
ERR_QUERIES = 1
WEIGHT_RTOL = 1e-4


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref(example: str):
    return _load(EXAMPLES / f"{example}.py", f"ref_{example}")


def _twin(example: str):
    return _load(EXAMPLES / f"{example}_torch.py", f"{example}_torch")


def _jax_common():
    sys.path.insert(0, str(ROOT))
    from benchmarks import common
    return common


def _torch_common():
    return _load(EXAMPLES / "common_torch.py", "common_torch")


@pytest.mark.parametrize("example", ["cascade_pipeline",
                                     "flash_crowd_autoscale"])
def test_virtual_clock_example_prints_the_reference_output(example, capsys):
    _ref(example).main()
    want = capsys.readouterr().out
    _twin(example).main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert want.count("\n") > 8
    assert got == want


def _fake_time_batch(fn, x, iters=5, **kw):
    """2 ms plus 0.1 ms a row: over the 20 ms SLO above 180 rows."""
    return 0.002 + 1e-4 * len(x)


def test_adaptive_batching_prints_the_reference_output(capsys,
                                                       monkeypatch):
    ref, twin = _ref("adaptive_batching_demo"), _twin(
        "adaptive_batching_demo")
    monkeypatch.setattr(ref, "time_batch", _fake_time_batch)
    monkeypatch.setattr(twin, "time_batch", _fake_time_batch)
    ref.main()
    want = capsys.readouterr().out
    paths = twin.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    # the deterministic timer made every controller back off
    for name, hist in paths.items():
        bs = [b for b, _ in hist]
        assert max(bs) > 180 and bs[-1] < max(bs), name
    assert "kernel_svm  : AIMD converged max batch" in got


@pytest.mark.parametrize("example", TWINS)
def test_twin_refuses_the_card_without_one(example, monkeypatch):
    """``--device`` defaults to ``cuda``, which raises without a card (no
    quiet run on the host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _twin(example).main([])


@pytest.fixture(scope="module")
def containers():
    fj = _jax_common().make_containers(np.random.default_rng(0))
    ft = _torch_common().make_containers(np.random.default_rng(0), "cpu")
    return fj, ft


@pytest.mark.parametrize("name", ["linear_svm", "mlp", "big_mlp",
                                  "kernel_svm", "noop"])
def test_containers_weights_bit_equal(containers, name):
    fj, ft = containers
    want = inspect.getclosurevars(fj[name].__wrapped__).nonlocals
    got = inspect.getclosurevars(ft[name]).nonlocals
    weights = {k for k, v in want.items() if hasattr(v, "shape")}
    assert weights == {k for k, v in got.items()
                       if isinstance(v, torch.Tensor)}
    for k in weights:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype == np.float32, k
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("name", ["linear_svm", "mlp", "big_mlp",
                                  "kernel_svm", "noop"])
def test_containers_predict_like_the_reference(containers, name, b):
    fj, ft = containers
    x = np.random.default_rng(b).normal(size=(b, 64)).astype(np.float32)
    want = np.asarray(fj[name](jnp.asarray(x)))
    got = ft[name](torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, 10)
    gap = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert gap <= PRED_RTOL, gap


def test_np_call_and_time_batch_on_the_cpu():
    T = _torch_common()
    fns = T.make_containers(np.random.default_rng(0), "cpu")
    x = np.random.default_rng(1).normal(size=(5, 64))      # float64
    y = T.np_call(fns["mlp"], "cpu")(x)
    assert isinstance(y, np.ndarray) and y.dtype == np.float32
    np.testing.assert_array_equal(
        y, fns["mlp"](torch.from_numpy(x.astype(np.float32))).numpy())
    assert T.time_batch(fns["linear_svm"], x, iters=3, device="cpu") > 0
    base, per_item = T.fit_linear_latency(
        fns["noop"], np.random.default_rng(2), sizes=(1, 4), device="cpu")
    assert base >= 1e-6 and per_item >= 1e-9


@pytest.mark.parametrize("noise,masked", [(0.5, False), (0.1, False),
                                          (0.3, True)])
def test_train_linear_model_like_the_reference(noise, masked):
    J, T = _jax_common(), _torch_common()
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    W, label = J.make_task(rj)
    Wt, label_t = T.make_task(rt)
    assert W.tobytes() == Wt.tobytes()
    mask = None
    if masked:
        mask = (np.arange(64) % 3 != 0).astype(np.float32)
    pj = J.train_linear_model(rj, W, noise=noise, feature_mask=mask)
    pt = T.train_linear_model(rt, Wt, noise=noise, feature_mask=mask,
                              device="cpu")
    # the generator was drawn exactly as the reference draws it
    assert rt.bit_generator.state == rj.bit_generator.state
    x = np.random.default_rng(9).normal(size=(1000, 64)).astype(np.float32)
    want = np.asarray(pj(jnp.asarray(x)))
    got = pt(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TRAIN_ATOL
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_array_equal(label_t(x), label(x))


_PHASE = re.compile(r"^  \[(\w+) *\] err=([0-9.]+)  weights=")


def _phases(out):
    """The three phase lines' error counts (of 400) and the other lines."""
    errs, rest = [], []
    for line in out.splitlines():
        m = _PHASE.match(line)
        if m:
            errs.append(round(float(m.group(2)) * 400))
            rest.append(m.group(1))
        else:
            rest.append(line)
    return errs, rest


def test_ensemble_serving_like_the_reference(capsys, monkeypatch):
    ref, twin = _ref("ensemble_serving"), _twin("ensemble_serving")
    seen = []
    real = ref.exp4_weights

    def recording(s):
        seen.append(np.asarray(real(s)))
        return seen[-1]

    monkeypatch.setattr(ref, "exp4_weights", recording)
    ref.main()
    want = capsys.readouterr().out
    res = twin.main(["--device", "cpu"])
    got = capsys.readouterr().out

    want_errs, want_rest = _phases(want)
    got_errs, got_rest = _phases(got)
    assert len(want_errs) == 3 and got_rest == want_rest
    assert got.splitlines()[-1].startswith("telemetry: served=1200 ")
    assert [round(e * 400) for e in res["errors"]] == got_errs
    for g, w in zip(got_errs, want_errs):
        assert abs(g - w) <= ERR_QUERIES
    assert len(seen) == 3
    for g, w in zip(res["weights"], seen):
        assert g.shape == w.shape == (5,)
        assert (np.abs(g - w) <= WEIGHT_RTOL * w).all()
    # the failed model lost its weight while it was down
    assert res["weights"][1][4] < 1e-3 < res["weights"][0][4]
