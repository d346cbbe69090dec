"""``repro_torch.launch.steps`` and ``launch.inputs`` against the JAX
package, on the CPU.

Inputs: the batch specs' shapes and dtypes equal the reference's for all 32
cells (meta tensors against ``ShapeDtypeStruct``s), and ``make_concrete``
draws the reference's numbers bit for bit.

Steps: ``build_{train,prefill,decode}_step`` for reduced smollm-360m
(dense), xlstm-125m (ssm) and dbrx-132b (moe), each against the reference's
``build_*_step`` on a 1 x 1 mesh, from the same weights (the reference's
``init``, bridged) and the same ``make_concrete`` inputs; decode starts
from the reference's prefill cache, bridged. Tolerances are the parity
tests' own:

* dense and ssm logits and caches: one bf16 rounding (rtol 2**-7, atol
  1e-6; ``test_torch_model.py``, ``test_torch_xlstm.py``), the xlstm
  state's fp32 leaves ``rtol 1e-5`` plus 2e-6 of their largest magnitude;
* moe: ``DRIFT`` = 2 bf16 roundings of the largest magnitude
  (``test_torch_moe.py``: capacity dispatch and the router's ulps);
* the train step (one AdamW step, default ``TrainConfig``): the loss within
  ``LOSS_RTOL`` and the grad norm within ``GRAD_ROUNDINGS`` bf16 roundings
  (``test_torch_train_parity.py``); each master leaf within ``OPT_RTOL`` of
  its largest magnitude plus two steps of the learning rate (Adam's first
  step moves a weight by about ``lr``, its sign that of a gradient a few
  roundings apart), bf16 params also within one rounding of the value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, f32

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import ARCHITECTURES as J_ARCHITECTURES
from repro.configs.registry import all_cells as j_all_cells
from repro.configs.registry import reduced_config as j_reduced_config
from repro.launch import inputs as j_inputs
from repro.launch import steps as j_steps
from repro.launch.mesh import compat_make_mesh
from repro.training import optimizer as j_opt
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.launch import inputs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import build_step
from repro_torch.training import optimizer as t_opt
from repro_torch.tree import flatten_with_paths

BF16_ULP = 2.0 ** -7
BF16_ROUNDING = 2.0 ** -8
DRIFT = 2
LOSS_RTOL = 5e-4
GRAD_ROUNDINGS = 6
OPT_RTOL = 5e-6
ARCHS = ("smollm-360m", "xlstm-125m", "dbrx-132b")
TRAIN = (32, 4)           # seq, batch
PREFILL = (16, 2)
DECODE_LEN = 32


def _torch_dtype(dt):
    return {"int32": torch.int32, "float32": torch.float32}[np.dtype(dt).name]


def test_batch_specs_match_reference_for_all_cells():
    """The meta specs of every cell have the reference's shapes and
    dtypes, and the same axes."""
    cells = list(j_all_cells())
    assert len(cells) == 32
    for jcfg, shape in cells:
        cfg = ARCHITECTURES[jcfg.name]
        tshape = ShapeSpec(shape.name, shape.seq_len, shape.global_batch,
                           shape.kind)
        for name in ("train_batch_specs", "prefill_batch_specs"):
            want = getattr(j_inputs, name)(jcfg, shape)
            got = getattr(inputs, name)(cfg, tshape)
            assert list(got) == list(want), (jcfg.name, name)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == want[k].shape, (jcfg.name, k)
                assert v.dtype == _torch_dtype(want[k].dtype), (jcfg.name, k)
            assert inputs.batch_axes_tree(got) == j_inputs.batch_axes_tree(
                want)
        for g, w in zip(inputs.decode_input_specs(cfg, tshape),
                        j_inputs.decode_input_specs(jcfg, shape)):
            assert (tuple(g.shape), g.dtype) == (w.shape,
                                                 _torch_dtype(w.dtype))


@pytest.mark.parametrize("arch", ["smollm-360m", "seamless-m4t-medium",
                                  "internvl2-1b"])
def test_make_concrete_is_the_references_bit_for_bit(arch):
    """The three batch layouts (plain, encdec frames, vlm prefix) at a small
    shape: every array equal bit for bit."""
    jcfg = j_reduced_config(J_ARCHITECTURES[arch])
    cfg = reduced_config(ARCHITECTURES[arch])
    for vocab in (1000, cfg.vocab_size):
        want = j_inputs.make_concrete(
            j_inputs.train_batch_specs(jcfg, JShapeSpec("t", 64, 3, "train")),
            vocab=vocab)
        got = inputs.make_concrete(
            inputs.train_batch_specs(cfg, ShapeSpec("t", 64, 3, "train")),
            vocab=vocab, device="cpu")
        assert list(got) == list(want)
        for k in want:
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


def test_make_concrete_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = inputs.train_batch_specs(ARCHITECTURES["smollm-360m"],
                                     ShapeSpec("t", 8, 2, "train"))
    with pytest.raises(RuntimeError, match="cuda"):
        inputs.make_concrete(specs)


# ---- the step builders ----

@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = j_reduced_config(J_ARCHITECTURES[arch])
    cfg = reduced_config(ARCHITECTURES[arch])
    return jcfg, cfg


def _mesh():
    return compat_make_mesh((1, 1), ("data", "model"))


def _close(arch, t, j, state=False):
    j = f32(j)
    if arch == "dbrx-132b":
        np.testing.assert_allclose(f32(t), j, rtol=0,
                                   atol=DRIFT * BF16_ULP * np.abs(j).max())
    elif state:
        np.testing.assert_allclose(
            f32(t), j, rtol=1e-5, atol=2e-6 * max(float(np.abs(j).max()), 1))
    else:
        np.testing.assert_allclose(f32(t), j, rtol=BF16_ULP, atol=1e-6)


def _leaves(tree):
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _jleaves(tree):
    return [leaf for _, leaf in flatten_with_paths(
        jax.tree.map(np.asarray, tree))]


def _prefill(arch, max_len=None):
    """(reference (bundle, out), port (bundle, out)) of one prefill step."""
    jcfg, cfg = _pair(arch)
    S, B = PREFILL
    opts = {} if max_len is None else {"max_len": max_len}
    mesh = _mesh()
    with mesh:
        jb = j_steps.build_step(jcfg, JShapeSpec("p", S, B, "prefill"), mesh,
                                **opts)
        jp = jb.model.init(jax.random.PRNGKey(0))
        jbatch = j_inputs.make_concrete(jb.arg_specs[1],
                                        vocab=jcfg.vocab_size)
        jout = jb.fn(jp, jbatch)
    tb = build_step(cfg, ShapeSpec("p", S, B, "prefill"),
                    make_local_mesh(device="cpu"), **opts)
    tp = bridged(jp)
    tbatch = inputs.make_concrete(tb.arg_specs[1], vocab=cfg.vocab_size,
                                  device="cpu")
    return (jb, jp, jout), (tb, tp, tb.fn(tp, tbatch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference(arch):
    (jb, _, (jl, jc)), (tb, _, (tl, tc)) = _prefill(arch)
    assert tb.meta == jb.meta and tb.rules == jb.rules
    assert [tuple(a.shape) for a in _leaves(tb.arg_specs[0])] == [
        a.shape for a in jax.tree.leaves(jb.arg_specs[0])]
    _close(arch, tl, jl)
    for t, j in zip(_leaves(tc), _jleaves(jc)):
        assert tuple(t.shape) == j.shape
        _close(arch, t, j, state=t.dtype == torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """From the reference's prefill cache (max_len 32), bridged: one decode
    step on ``make_concrete`` tokens, logits and the updated cache."""
    jcfg, cfg = _pair(arch)
    (_, jp, (_, jcache)), (_, tp, _) = _prefill(arch, DECODE_LEN)
    B = PREFILL[1]
    shape = ("d", DECODE_LEN, B, "decode")
    mesh = _mesh()
    with mesh:
        jb = j_steps.build_step(jcfg, JShapeSpec(*shape), mesh)
        tok = j_inputs.make_concrete({"tokens": jb.arg_specs[2]},
                                     vocab=jcfg.vocab_size)["tokens"]
        lengths = jcache["lengths"]
        tcache = jax.tree.map(
            lambda a: tensor_from_numpy(np.asarray(a), device="cpu"), jcache)
        jl, jc = jb.fn(jp, jcache, tok, lengths)
    tb = build_step(cfg, ShapeSpec(*shape), make_local_mesh(device="cpu"))
    assert tb.meta == jb.meta and tb.rules == jb.rules
    assert [tuple(a.shape) for a in _leaves(tb.arg_specs[1])] == [
        a.shape for a in jax.tree.leaves(jb.arg_specs[1])]
    ttok = inputs.make_concrete({"tokens": tb.arg_specs[2]},
                                vocab=cfg.vocab_size, device="cpu")["tokens"]
    tl, tc = tb.fn(tp, tcache, ttok, tcache["lengths"].clone())
    _close(arch, tl, jl)
    for t, j in zip(_leaves(tc), _jleaves(jc)):
        _close(arch, t, j, state=t.dtype == torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of each package's train step from the same weights, AdamW
    state and ``make_concrete`` batch."""
    jcfg, cfg = _pair(arch)
    S, B = TRAIN
    mesh = _mesh()
    with mesh:
        jb = j_steps.build_step(jcfg, JShapeSpec("t", S, B, "train"), mesh)
        jp = jb.model.init(jax.random.PRNGKey(0))
        tp = bridged(jp)                 # the reference donates its params
        # fp32 leaves' master copies alias the params: copy, as both are
        # donated
        jopt = jax.tree.map(jnp.copy, j_opt.adamw_init(jp))
        jbatch = j_inputs.make_concrete(jb.arg_specs[2],
                                        vocab=jcfg.vocab_size)
        jp2, jopt2, jm = jb.fn(jp, jopt, jbatch)
    tb = build_step(cfg, ShapeSpec("t", S, B, "train"),
                    make_local_mesh(device="cpu"))
    assert tb.meta == jb.meta and tb.rules == jb.rules
    tbatch = inputs.make_concrete(tb.arg_specs[2], vocab=cfg.vocab_size,
                                  device="cpu")
    tp2, topt2, tm = tb.fn(tp, t_opt.adamw_init(tp), tbatch)
    jl, tl = float(jm["loss"]), float(tm["loss"])
    assert np.isfinite(tl) and abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert abs(float(tm["gnorm"]) - float(jm["gnorm"])) <= (
        GRAD_ROUNDINGS * BF16_ROUNDING * float(jm["gnorm"]))
    lr = float(jm["lr"])
    for t, j in zip(_leaves((tp2, topt2.master)),
                    _jleaves((jp2, jopt2.master))):
        j32 = f32(j)
        atol = OPT_RTOL * np.abs(j32).max() + 2.02 * lr
        err = np.abs(f32(t) - j32)
        if t.dtype == torch.bfloat16:
            err = np.maximum(err - BF16_ULP * np.abs(j32), 0)
        assert err.max() <= atol, (arch, err.max(), atol)
    assert int(topt2.step) == int(jopt2.step) == 1
