"""Port-side copy of tests/test_training.py: the port's training substrate
(``repro_torch.training``): optimizer, grad accumulation, compression,
loop; on the CPU."""

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.data.pipeline import data_iter
from repro_torch.models.api import build_model
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.grad_compress import (
    _accumulate, _quantized_pod_mean,
)
from repro_torch.training.train_loop import (
    TrainConfig, make_train_step, train,
)
from repro_torch.tree import leaves, tree_map


def _grad(loss, w):
    """d loss / d w for a tree ``w`` of leaf tensors."""
    live = tree_map(lambda p: p.detach().requires_grad_(), w)
    g = torch.autograd.grad(loss(live), leaves(live))
    it = iter(g)
    return tree_map(lambda _: next(it), w)


def test_adamw_reduces_quadratic():
    w = {"w": torch.tensor([5.0, -3.0])}
    state = opt_lib.adamw_init(w)
    loss = lambda p: torch.sum(p["w"] ** 2)
    for _ in range(200):
        g = _grad(loss, w)
        w, state, _ = opt_lib.adamw_update(g, state, w, lr=0.05,
                                           weight_decay=0.0)
    assert float(loss(w)) < 1e-2


def test_adafactor_reduces_quadratic():
    w = {"w": torch.ones((4, 4)) * 3.0}
    state = opt_lib.adafactor_init(w)
    loss = lambda p: torch.sum(p["w"] ** 2)
    for _ in range(300):
        g = _grad(loss, w)
        w, state, _ = opt_lib.adafactor_update(g, state, w, lr=0.05)
    assert float(loss(w)) < 1e-1


def test_grad_clip_bounds_update():
    w = {"w": torch.tensor([0.0])}
    state = opt_lib.adamw_init(w)
    huge = {"w": torch.tensor([1e9])}
    w2, _, gnorm = opt_lib.adamw_update(huge, state, w, lr=0.1,
                                        weight_decay=0.0, grad_clip=1.0)
    assert float(gnorm) == pytest.approx(1e9)
    assert abs(float(w2["w"][0])) < 1.0


def test_cosine_schedule_shape():
    sched = opt_lib.cosine_schedule(1e-3, warmup=10, total=100)
    assert float(sched(0)) == 0.0
    assert float(sched(10)) == pytest.approx(1e-3, rel=1e-5)
    assert float(sched(100)) < 1e-5
    assert float(sched(55)) < float(sched(20))


def test_microbatch_accumulation_matches_full_batch():
    rng = np.random.default_rng(0)
    W = torch.tensor(rng.normal(size=(4, 2)), dtype=torch.float32)
    x = torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(8, 2)), dtype=torch.float32)
    loss_fn = lambda p, b: torch.mean((b["x"] @ p - b["y"]) ** 2)
    l1, g1 = _accumulate(loss_fn, W, {"x": x, "y": y}, 1)
    l4, g4 = _accumulate(loss_fn, W, {"x": x, "y": y}, 4)
    assert float(l1) == pytest.approx(float(l4), rel=1e-5)
    np.testing.assert_allclose(g1.numpy(), g4.numpy(), rtol=1e-5)


@given(st.integers(0, 5))
@settings(max_examples=10, deadline=None)
def test_int8_quantization_error_bound(seed):
    """|dequant(quant(g)) - mean(g)| <= scale = max|g|/127 per element."""
    rng = np.random.default_rng(seed)
    g = torch.tensor(rng.normal(size=(2, 16))
                     * 10.0 ** float(rng.integers(-3, 3)),
                     dtype=torch.float32)
    out = _quantized_pod_mean(g)
    ref = torch.mean(g, dim=0)
    scale = float(torch.max(torch.abs(g))) / 127.0
    assert float(torch.max(torch.abs(out - ref))) <= scale + 1e-7


def test_training_loss_decreases():
    cfg = reduced_config(ARCHITECTURES["smollm-360m"])
    shape = ShapeSpec("tiny", 32, 8, "train")
    model = build_model(cfg, device="cpu")
    tc = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=40,
                     num_microbatches=2)
    out = train(model, tc, data_iter(cfg, shape), num_steps=25,
                log_every=5)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] * 0.8


def test_nan_step_skipped():
    """A batch that produces a NaN loss must not corrupt parameters: the
    step reports it, and params and optimizer state come back as they went
    in (bit for bit, NaN where they were NaN)."""
    cfg = reduced_config(ARCHITECTURES["smollm-360m"], num_layers=2)
    shape = ShapeSpec("tiny", 16, 4, "train")
    model = build_model(cfg, device="cpu")
    tc = TrainConfig(num_microbatches=1, skip_nan_steps=True)
    step, opt_init = make_train_step(model, tc)
    params = model.init(torch.Generator().manual_seed(0))
    # poison the loss: scale params to inf
    poisoned = tree_map(lambda p: p * float("inf"), params)
    batch = {k: torch.from_numpy(v) for k, v in next(
        data_iter(cfg, shape)).items()}
    opt = opt_init(poisoned)
    p2, o2, m = step(poisoned, opt, batch)
    assert not np.isfinite(float(m["loss"]))
    for a, b in zip(leaves((poisoned, opt)), leaves((p2, o2))):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
