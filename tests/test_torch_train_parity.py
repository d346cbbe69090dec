"""Training slice parity: the port's ``loss_fn``s, gradients, accumulation,
optimizers, schedule, pod compression, data, checkpoints and the training
loop against the JAX package, on the CPU.

The six reduced configurations of ``_torch_parity`` (g3 dense, x8 xlstm, h5
hymba with windowed layers, ed1 encdec, vl7 vlm with its prefix, mo6 moe)
get the same bridged weights and the same ``SyntheticLMData`` batch (B 4,
seq 32). Tolerances, and the rounding points behind each:

* loss: ``LOSS_RTOL`` relative. The two libraries sum fp32 products in
  other orders, so a bf16 activation can round the other way; the encdec
  encoder's rounding points are not settled (ROADMAP §C), which gives the
  largest gap (2.0e-4 on ed1; dense, xlstm, vlm and moe are within 2.2e-5).
* gradients: each leaf within ``GRAD_ROUNDINGS`` bf16 roundings (2**-8) of
  its largest |g|. Both backward passes round every cotangent to bf16, at
  points that differ where XLA fuses: the residual sum feeding the next
  RMSNorm unrounded (``add_rmsnorm``) holds under ``jax.checkpoint`` for
  the forward, but its cotangent rounds once in XLA's graph and not in the
  port's. Seen: up to 3.9 roundings (ed1). hymba's fp32 SSD leaves
  ``ssd/d_skip`` and ``ssd/b_dt`` are held to ``SSD_GATE_ROUNDINGS``: their
  cotangents are sums over B * S * head_dim bf16 products that the SSD
  state amplifies, and the reference's own bf16 path lies up to 29
  roundings from an fp32 run there (h5; the port's 33).
* optimizer steps are fed the same fp32 gradients (the JAX ones): the
  grad norm, master, m and v within ``OPT_RTOL`` of the leaf's largest
  magnitude, bf16 params also within one bf16 rounding. The global norm
  sums every gradient element in fp32 in another order: the reference's
  lies up to 1.1e-6 from a float64 sum (vl7), the port's within 1e-7, and
  v is quadratic in the clip scale it gives (seen: 2.3e-6).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import build_pair, f32

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data.pipeline import SyntheticLMData as JSyntheticLMData
from repro.distributed.sharding import train_rules
from repro.launch.mesh import compat_make_mesh
from repro.training import optimizer as j_opt
from repro.training.grad_compress import _accumulate as j_accumulate
from repro.training.grad_compress import _quantized_pod_mean as j_pod_mean
from repro.training.train_loop import TrainConfig as JTrainConfig
from repro.training.train_loop import train as j_train
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import SyntheticLMData, data_iter
from repro_torch.models.api import build_model
from repro_torch.training import optimizer as t_opt
from repro_torch.training.grad_compress import (
    _accumulate, _quantized_pod_mean, _wire_sum,
)
from repro_torch.training.train_loop import TrainConfig, train
from repro_torch.tree import (
    flatten_with_paths, leaves, tree_map, unflatten_like,
)

NAMES = ("g3", "x8", "h5", "ed1", "vl7", "mo6")
LOSS_RTOL = 5e-4
GRAD_ROUNDINGS = 6
SSD_GATE_ROUNDINGS = 40
OPT_RTOL = 5e-6
TRAIN_RTOL = 2e-3
BF16_ROUNDING = 2.0 ** -8
SHAPE = (32, 4)                 # seq, batch


@functools.lru_cache(maxsize=None)
def _pair(name):
    return build_pair(name)


def _batch(cfg, step=0):
    """The port's synthetic batch (numpy), the same bytes as the
    reference's (test_data_batches_match_reference)."""
    S, B = SHAPE
    return SyntheticLMData(cfg, ShapeSpec("t", S, B, "train"),
                           seed=1).batch_at(step)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _grads(name, n):
    """(JAX (loss, grads), port (loss, grads)) of ``_accumulate`` at ``n``
    microbatches; grads as {path: fp32 numpy}."""
    jm, jp, tm, tp = _pair(name)
    b = _batch(tm.cfg)
    jl, jg = jax.jit(lambda p, bb: j_accumulate(jm.loss_fn, p, bb, n))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tl, tg = _accumulate(tm.loss_fn, tp, _torch(b), n)
    as_np = lambda tree: {p: f32(g) for p, g in flatten_with_paths(tree)}
    return (float(jl), as_np(jg)), (float(tl), as_np(tg))


def _roundings(path: str) -> int:
    return (SSD_GATE_ROUNDINGS if path.endswith(("ssd/d_skip", "ssd/b_dt"))
            else GRAD_ROUNDINGS)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name, n):
    """``_accumulate(model.loss_fn, ...)`` at 1 and 2 microbatches: the
    loss within ``LOSS_RTOL``, each gradient leaf within its number of bf16
    roundings of the leaf's largest |g| (module docstring)."""
    (jl, jg), (tl, tg) = _grads(name, n)
    assert np.isfinite(tl) and abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert sorted(tg) == sorted(jg)
    for path, g in tg.items():
        ref = jg[path]
        assert g.shape == ref.shape and np.isfinite(g).all(), path
        err = np.abs(g - ref).max() / (np.abs(ref).max() * BF16_ROUNDING)
        assert err <= _roundings(path), (path, err)


@pytest.mark.parametrize("name", NAMES)
def test_remat_modes_are_bit_equal(name):
    """Remat changes what the backward pass keeps, never a value: the loss
    and every gradient bit for bit under ``"full"``, ``"dots"`` and
    ``"none"``."""
    _, _, tm, tp = _pair(name)
    b = _torch(_batch(tm.cfg))
    out = {}
    for mode in ("full", "dots", "none"):
        m = build_model(tm.cfg, device="cpu", remat=mode,
                        **({"chunk": 8} if name in ("x8", "h5") else {}))
        out[mode] = _accumulate(m.loss_fn, tp, b, 1)
    for mode in ("dots", "none"):
        assert torch.equal(out[mode][0], out["full"][0]), mode
        for a, c in zip(leaves(out[mode][1]), leaves(out["full"][1])):
            assert torch.equal(a, c), mode


@functools.lru_cache(maxsize=None)
def _opt_inputs(name):
    """(JAX params, port params, JAX grads, the same grads for the port):
    the gradients are the reference's fp32 ones."""
    jm, jp, tm, tp = _pair(name)
    jg = _grads(name, 1)[0][1]
    grads_t = unflatten_like(tp, [torch.from_numpy(jg[p].copy())
                                  for p, _ in flatten_with_paths(tp)])
    grads_j = jax.tree_util.tree_map_with_path(
        lambda kp, _: jnp.asarray(jg["/".join(str(k.key) for k in kp)]), jp)
    return jp, tp, grads_j, grads_t


def _close(port_tree, ref_tree, label):
    """Each leaf within ``OPT_RTOL`` of its largest magnitude (fp32 ulps of
    the operands: a result that cancels to near 0 keeps their error), bf16
    leaves also within one bf16 rounding of the value."""
    ref = {p: f32(v) for p, v in flatten_with_paths(
        jax.tree.map(np.asarray, ref_tree))}
    for path, v in flatten_with_paths(port_tree):
        got, want = f32(v), ref[path]
        tol = OPT_RTOL * np.abs(want).max() + 1e-30
        if v.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * np.abs(want)
        assert (np.abs(got - want) <= tol).all(), (label, path)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_step_matches_reference(name, opt):
    """One step of each optimizer from a fresh state on the same params and
    the same fp32 gradients (the JAX ones: AdamW's first update is about
    sign(g), so a gradient one ulp from zero would otherwise flip it)."""
    jp, tp, jg, tg = _opt_inputs(name)
    j_init, j_upd = getattr(j_opt, f"{opt}_init"), getattr(
        j_opt, f"{opt}_update")
    t_init, t_upd = getattr(t_opt, f"{opt}_init"), getattr(
        t_opt, f"{opt}_update")
    jnew, jstate, jnorm = jax.jit(lambda g, s, p: j_upd(g, s, p, lr=1e-3))(
        jg, j_init(jp), jp)
    tnew, tstate, tnorm = t_upd(tg, t_init(tp), tp, lr=1e-3)
    assert abs(float(tnorm) - float(jnorm)) <= OPT_RTOL * abs(float(jnorm))
    assert int(tstate.step) == int(jstate.step) == 1
    _close(tnew, jnew, "params")
    for field in tstate._fields[1:]:
        _close(getattr(tstate, field), getattr(jstate, field), field)


def test_cosine_schedule_matches_reference():
    """Exactly at step 0, at the end of warmup and at the total; within one
    fp32 rounding between."""
    j, t = j_opt.cosine_schedule(3e-4, 10, 100), t_opt.cosine_schedule(
        3e-4, 10, 100)
    for step in (0, 10, 100):
        assert float(t(step)) == float(j(step)), step
    for step in (1, 5, 37, 99, 150):
        assert float(t(step)) == pytest.approx(float(j(step)), rel=2e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantized_pod_mean_matches_reference(seed):
    """Bit for bit, and the pod sum is int16 in both (the reference's
    ``dtype=jnp.int16`` shows in its jaxpr)."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(4, 3, 16)) * 10.0 ** rng.integers(-3, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(j_pod_mean)(jnp.asarray(g)))
    got = _quantized_pod_mean(torch.from_numpy(g)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    jaxpr = str(jax.make_jaxpr(j_pod_mean)(jnp.asarray(g)))
    assert "reduce_sum" in jaxpr and "i16" in jaxpr
    q = torch.from_numpy(rng.integers(-127, 128, size=(4, 8)).astype(np.int8))
    assert _wire_sum(q).dtype == torch.int16


@pytest.mark.parametrize("name", ["g3", "ed1", "vl7"])
def test_data_batches_match_reference(name):
    """The same seed, step and shard give the same bytes, every key."""
    jm = _pair(name)[0]
    _, _, tm, _ = _pair(name)
    for step, (hosts, host) in ((0, (1, 0)), (7, (2, 1))):
        kw = dict(seed=3, num_hosts=hosts, host_id=host)
        want = JSyntheticLMData(jm.cfg, JShapeSpec("t", 32, 4, "train"),
                                **kw).batch_at(step)
        got = SyntheticLMData(tm.cfg, ShapeSpec("t", 32, 4, "train"),
                              **kw).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k


def _state_trees(name):
    """Params and a non-trivial AdamW state of both packages (one step on
    the same gradients)."""
    jp, tp, jg, tg = _opt_inputs(name)
    jnew, jstate, _ = j_opt.adamw_update(jg, j_opt.adamw_init(jp), jp,
                                         lr=1e-3)
    tnew, tstate, _ = t_opt.adamw_update(tg, t_opt.adamw_init(tp), tp,
                                         lr=1e-3)
    return {"params": jnew, "opt": jstate}, {"params": tnew, "opt": tstate}


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint written by either package restores bit for bit in the
    other; both write the same manifest (paths, keys, shapes, dtypes)."""
    jtrees, ttrees = _state_trees("g3")
    JCheckpointer(str(tmp_path / "ref")).save(3, jtrees)
    Checkpointer(str(tmp_path / "port")).save(3, ttrees)
    assert ((tmp_path / "ref" / "step_00000003" / "manifest.json")
            .read_text() == (tmp_path / "port" / "step_00000003"
                             / "manifest.json").read_text())
    if writer == "port":
        ck = JCheckpointer(str(tmp_path / "port"))
        for name in ("params", "opt"):
            shapes = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                jtrees[name])
            back = ck.restore(3, name, shapes)
            for a, b in zip(leaves(ttrees[name]), jax.tree.leaves(back)):
                assert _raw(a) == _raw(b)
    else:
        ck = Checkpointer(str(tmp_path / "ref"))
        for name in ("params", "opt"):
            target = tree_map(torch.empty_like, ttrees[name])
            back = ck.restore(3, name, target)
            for a, b in zip(jax.tree.leaves(jtrees[name]), leaves(back)):
                assert _raw(a) == _raw(b)


def test_train_loss_history_matches_reference():
    """Ten steps of ``train`` (AdamW, 2 microbatches, warmup 3) from the
    same weights (the reference's ``init`` at seed 0, bridged) on the same
    data: each step's loss within
    ``TRAIN_RTOL`` of the reference's. The gradients part by a few bf16
    roundings each step (above), the updates by a few fp32 ulps, and the
    weights drift apart as the steps compound (seen: 3.4e-4 at step 10)."""
    jm, jp, tm, tp = _pair("g3")
    S, B = SHAPE
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    rules = train_rules(False)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=10, num_microbatches=2)
    with mesh:
        jout = j_train(jm, mesh, rules, JTrainConfig(**kw),
                       JSyntheticLMData(jm.cfg, JShapeSpec("t", S, B, "train"),
                                        seed=1).iterator(),
                       num_steps=10, log_every=1)
    tout = train(tm, TrainConfig(**kw),
                 data_iter(tm.cfg, ShapeSpec("t", S, B, "train"), seed=1),
                 num_steps=10, log_every=1, params=tp)
    jl = np.array([h["loss"] for h in jout["history"]])
    tl = np.array([h["loss"] for h in tout["history"]])
    assert len(tl) == len(jl) == 10
    np.testing.assert_allclose(tl, jl, rtol=TRAIN_RTOL)
    assert tl[-1] < tl[0]


def test_resume_matches_uninterrupted_run(tmp_path):
    """Six steps straight, against three steps with a checkpoint, then a
    fresh ``train`` that resumes from it (data seeked to step 3): the final
    params and optimizer state bit for bit, and the same logged losses."""
    _, _, tm, _ = _pair("g3")
    S, B = SHAPE
    shape = ShapeSpec("t", S, B, "train")
    tc = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                     num_microbatches=2)
    straight = train(tm, tc, data_iter(tm.cfg, shape), num_steps=6,
                     log_every=1)
    ckpt = str(tmp_path / "ckpt")
    first = train(tm, tc, data_iter(tm.cfg, shape), num_steps=3,
                  checkpoint_dir=ckpt, checkpoint_every=3, log_every=1)
    resumed = train(tm, tc, data_iter(tm.cfg, shape, start_step=3),
                    num_steps=6, checkpoint_dir=ckpt, log_every=1)
    assert Checkpointer(ckpt).steps() == [3, 6]
    assert ([h["loss"] for h in first["history"] + resumed["history"]]
            == [h["loss"] for h in straight["history"]])
    for a, b in zip(leaves((straight["params"], straight["opt_state"])),
                    leaves((resumed["params"], resumed["opt_state"]))):
        assert torch.equal(a, b)
