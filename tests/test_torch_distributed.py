"""The sharded variants on ``torch.distributed``, on the CPU: the port as
gloo worlds of spawned ranks (``repro_torch.launch.mesh.run_ranks``; the
rank programs are ``tests/_torch_dist_ranks.py``), the reference in one
subprocess with 8 forced host devices, as ``test_perf_variants.py`` runs
it. Both sides take the reference's ``init`` params (through
``bridge.params_for_rank``) and the same inputs from
``np.random.default_rng(0)``, at ``test_perf_variants.py``'s sizes and
meshes: (2, 4) over (data, model) and (2, 2, 2) over (pod, data, model).

Every world starts through a ``file://`` rendezvous under the test's temp
directory, every collective fails after 60 s, and the parent kills a world
that outlives its deadline, so a failing rank fails its test and never
hangs the suite."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_dist_ranks as R
from _torch_ties import bf16_ulp, record_logits
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import mesh as t_mesh
from repro_torch.models.api import build_model
from repro_torch.serving import engine as t_engine
from repro_torch.training.grad_compress import loss_and_grads
from repro_torch.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7

REFERENCE = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ShapeSpec
from repro.configs.registry import ARCHITECTURES, reduced_config
from repro.distributed.sharding import serve_rules, strip_pod, train_rules
from repro.launch.mesh import compat_make_mesh
from repro.models.api import build_model
from repro.training.grad_compress import (
    _accumulate, _quantized_pod_mean, loss_and_grads)

out_dir = sys.argv[1]
outs = {}


def save_tree(name, tree):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(p.key for p in path)
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            flat[key + "::bf16"] = a.view(np.uint16)
        else:
            flat[key] = a
    np.savez(f"{out_dir}/{name}.npz", **flat)


f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
cfg_of = lambda a: reduced_config(ARCHITECTURES[a], num_layers=2, d_model=64)
mesh = compat_make_mesh((2, 4), ("data", "model"))
ids = np.vectorize(lambda d: d.id)
outs["mesh24_ids"] = ids(mesh.devices)

rng = np.random.default_rng(0)
cfg = cfg_of("granite-8b")
toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
with mesh:
    rules = serve_rules(False)
    m1 = build_model(cfg, mesh, rules, q_block=16, k_block=16)
    params = m1.init(jax.random.PRNGKey(1))
    pre = lambda m: jax.jit(lambda p, t: m.prefill(p, {"tokens": t}))
    lg1, _ = pre(m1)(params, toks)
    m2 = build_model(cfg, mesh, dict(rules, seq="model"), q_block=16,
                     k_block=16)
    lg2, _ = pre(m2)(params, toks)
save_tree("cp_params", params)
outs.update(cp_tokens=toks, cp_tp_logits=f32(lg1), cp_cp_logits=f32(lg2))

rng = np.random.default_rng(0)
cfg = dataclasses.replace(cfg_of("dbrx-132b"), moe_capacity_factor=8.0)
batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)}
with mesh:
    rules = train_rules(False)
    m1 = build_model(cfg, mesh, rules)
    params = m1.init(jax.random.PRNGKey(1))
    l1 = jax.jit(m1.loss_fn)(params, batch)
    rules_dp = dict(rules, batch=("data", "model"), fsdp=("data",),
                    heads=None, kv_heads=None, ffn=None, vocab=None)
    m2 = build_model(cfg, mesh, rules_dp)
    l2 = jax.jit(m2.loss_fn)(params, batch)
save_tree("dp_params", params)
outs.update(dp_tokens=batch["tokens"], dp_labels=batch["labels"],
            dp_base_loss=f32(l1), dp_dpm_loss=f32(l2))

rng = np.random.default_rng(0)
cfg = dataclasses.replace(cfg_of("kimi-k2-1t-a32b"), moe_capacity_factor=8.0)
toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
with mesh:
    r2d = serve_rules(False, shard_experts_2d=True)
    m1 = build_model(cfg, mesh, r2d)
    params = m1.init(jax.random.PRNGKey(1))
    lg1, _ = pre(m1)(params, toks)
    m2 = build_model(cfg, mesh, dict(serve_rules(False), fsdp="data"))
    lg2, _ = pre(m2)(params, toks)
save_tree("ep2d_params", params)
outs.update(ep2d_tokens=toks, ep2d_ep2d_logits=f32(lg1),
            ep2d_gather_logits=f32(lg2))

mesh3 = compat_make_mesh((2, 2, 2), ("pod", "data", "model"))
outs["mesh222_ids"] = ids(mesh3.devices)
rng = np.random.default_rng(0)
cfg = cfg_of("granite-8b")
batch = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(np.int32)}
with mesh3:
    model = build_model(cfg, mesh3, strip_pod(train_rules(True)))
    params = model.init(jax.random.PRNGKey(1))
    loss, grads = jax.jit(lambda p, b: loss_and_grads(
        model.loss_fn, p, b, mesh3, num_microbatches=2))(params, batch)
    acc = jax.jit(lambda p, b: _accumulate(model.loss_fn, p, b, 2))
    pods = [acc(params, {k: v[4 * i:4 * i + 4] for k, v in batch.items()})[1]
            for i in range(2)]
stacked = jax.tree.map(lambda *g: jnp.stack(g), *pods)
qmean = jax.tree.map(_quantized_pod_mean, stacked)
save_tree("pod_params", params)
save_tree("pod_grads", jax.tree.map(f32, grads))
save_tree("pod_qmean", jax.tree.map(f32, qmean))
save_tree("pod_amax", jax.tree.map(lambda g: f32(jnp.abs(g).max()), stacked))
outs.update(pod_tokens=batch["tokens"], pod_labels=batch["labels"],
            pod_loss=f32(loss))
np.savez(f"{out_dir}/outputs.npz", **outs)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's params and outputs, computed once (one JAX start)."""
    d = tmp_path_factory.mktemp("dist_ref")
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": str(Path.home())}
    if os.environ.get("JAX_PLATFORMS"):
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(d)], capture_output=True, text=True, cwd=ROOT,
                       env=env, timeout=600)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-3000:]
    return d, dict(np.load(d / "outputs.npz"))


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    """Every (2, 4) and (2, 2, 2) case, run once on one world of 8 ranks."""
    return t_mesh.run_ranks(R.world_8, 8, str(ref[0]), device="cpu",
                            timeout=240,
                            tmpdir=str(tmp_path_factory.mktemp("world8")))


def _rows_by_data(world, key, members):
    """The global batch of per-rank rows: ranks at model index 0, by
    data index."""
    return np.concatenate([world[r][key] for r in members])


def _calls(record, dtype=None):
    """{(op, axes): calls} of a rank's collective record (of one dtype)."""
    out = {}
    for e in record:
        if dtype in (None, e["dtype"]):
            key = (e["op"], tuple(e["axes"]))
            out[key] = out.get(key, 0) + e["calls"]
    return out


def _bf16_rounds(a, b):
    """max |a - b| in bf16 roundings of the largest |b|."""
    return float(np.abs(a - b).max() / (BF16_ULP * np.abs(b).max()))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_matches_the_reference_device_order(ref, world):
    """Each rank's coordinates are its place in the reference's device
    grid, and each axis group holds the ranks that differ only along it."""
    _, out = ref
    for key, axes in (("mesh24", ("data", "model")),
                      ("mesh222", ("pod", "data", "model"))):
        ids = out[f"{key}_ids"]
        for rank, w in enumerate(world):
            coords = w[key]["coords"]
            assert tuple(coords) == axes
            assert ids[tuple(coords[a] for a in axes)] == rank
            for names, members in w[key]["members"].items():
                fixed = [a for a in axes if a not in names]
                want = [r for r in range(8)
                        if all(world[r][key]["coords"][a] == coords[a]
                               for a in fixed)]
                assert list(members) == want
                assert rank in members


def test_run_ranks_asks_for_the_card_by_default(monkeypatch, tmp_path):
    """``run_ranks`` runs its ranks on the card unless asked for the CPU:
    without one it raises through ``resolve_device``, before it spawns a
    rank."""
    import inspect
    assert inspect.signature(t_mesh.run_ranks).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        t_mesh.run_ranks(_fail_on_rank_1, 2, timeout=10,
                         tmpdir=str(tmp_path))


def test_more_ranks_than_cards_raises_without_share(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="share=True"):
        t_mesh._world_device("cuda", 1, False, 4)
    assert t_mesh._world_device("cuda", 3, True, 4) == torch.device("cuda", 0)


def test_a_failing_rank_fails_the_world_in_time(tmp_path):
    """A rank that raises fails ``run_ranks`` with its traceback, and the
    ranks waiting on it in a collective are killed, well before the
    collectives' own 60 s timeout."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        t_mesh.run_ranks(_fail_on_rank_1, 2, device="cpu", timeout=60,
                         tmpdir=str(tmp_path))
    assert time.monotonic() - t0 < 40


def _fail_on_rank_1(rank):
    import torch.distributed as dist
    if rank == 1:
        raise ValueError("rank 1 gives up")
    dist.barrier()


# ---------------------------------------------------------------------------
# context-parallel prefill (granite-8b reduced, tokens (2, 64), blocks 16)
# ---------------------------------------------------------------------------

def _one_device(cfg, tp, tree, **opts):
    m = build_model(cfg.padded_config(tp), device="cpu", **opts)
    return m, params_from_numpy(tree, "cpu")


def test_context_parallel_prefill(ref, world):
    d, out = ref
    cfg = R.config(R.CP_CASE["arch"])
    blk = R.CP_CASE["block"]
    m, params = _one_device(cfg, 4, R.load_tree(d / "cp_params.npz"),
                            q_block=blk, k_block=blk)
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": torch.from_numpy(
            out["cp_tokens"])})
    one = logits.float().numpy()
    rows = [0, 4]                          # model index 0 of data 0 and 1
    cp = _rows_by_data(world, "cp_logits", rows)
    tp = _rows_by_data(world, "tp_logits", rows)
    # every model rank of a data row holds the same logits and cache
    for r in range(8):
        base = 4 * (r // 4)
        assert np.array_equal(world[r]["cp_logits"],
                              world[base]["cp_logits"])
        for k in ("k", "v"):
            assert np.array_equal(world[r]["cp_cache"][k],
                                  world[base]["cp_cache"][k])
    # the port's CP logits and cache are its one-device ones, bit for bit
    # (the layers gather their weights, so the same blocks meet the same
    # products)
    assert np.array_equal(cp, one)
    for k in ("k", "v"):
        got = np.concatenate([world[r]["cp_cache"][k] for r in rows], axis=1)
        assert np.array_equal(got, cache[k].float().numpy())
    # dense TP sums each rank's heads' and d_ff columns' partial products
    # over model: within 2 bf16 roundings of the one device's logits
    print("tp against one device:", _bf16_rounds(tp, one), "roundings")
    assert _bf16_rounds(tp, one) <= 2.0
    # each rank's cache holds its kv head of the one device's
    for r in range(8):
        h = r % 4
        for k in ("k", "v"):
            want = cache[k].float().numpy()[:, r // 4:r // 4 + 1, :,
                                            h:h + 1]
            assert world[r]["tp_cache"][k].shape == want.shape
            assert _bf16_rounds(world[r]["tp_cache"][k], want) <= 2.0
    # one decode step from the prefill: each rank's cache holds its kv
    # head, and the logits stay within 2 roundings of one device's
    with torch.no_grad():
        toks = torch.from_numpy(out["cp_tokens"])
        _, c1 = m.prefill(params, {"tokens": toks}, max_len=toks.shape[1] + 1)
        d1, c1 = m.decode_step(params, c1, toks[:, :1], c1["lengths"].clone())
    dec = _rows_by_data(world, "tp_decode_logits", rows)
    print("tp decode against one device:", _bf16_rounds(dec, d1.float()
                                                        .numpy()))
    assert _bf16_rounds(dec, d1.float().numpy()) <= 2.0
    for r in range(8):
        for k in ("k", "v"):
            want = c1[k].float().numpy()[:, r // 4:r // 4 + 1, :,
                                         r % 4:r % 4 + 1]
            assert _bf16_rounds(world[r]["tp_decode_cache"][k], want) <= 2.0
    # against the reference: its own bound is 0.1; both of its layouts
    # stay within 2 bf16 roundings of the largest logit of the port's
    ref_cp, ref_tp = out["cp_cp_logits"], out["cp_tp_logits"]
    print("tp against the reference's TP:", _bf16_rounds(tp, ref_tp),
          "roundings")
    assert float(np.abs(cp - ref_cp).max()) < 0.1
    assert _bf16_rounds(cp, ref_cp) <= 2.0
    assert _bf16_rounds(tp, ref_tp) <= 2.0
    # CP: K/V travel by one all_gather each a layer over model, and each
    # layer gathers its 7 dense weights, the embedding and head theirs
    rec = _calls(world[0]["cp_record"])
    assert rec[("all_gather", ("model",))] == 2 * 2 + 1 + 2 * 7 + 2
    # TP: the embedding's, each layer's attention and FFN sums over model
    # (in fp32), and the logits gathered over the vocab
    assert _calls(world[0]["tp_record"]) == {("psum", ("model",)): 1 + 2 * 2,
                                             ("all_gather", ("model",)): 1}
    assert _calls(world[0]["tp_record"], "float32") == {
        ("psum", ("model",)): 2 * 2}


# ---------------------------------------------------------------------------
# dp-major training (dbrx reduced, capacity 8, batch (8, 32))
# ---------------------------------------------------------------------------

# the sharded step sums the same bf16 products in other groupings (the
# experts' capacity buffers, the ranks' partial sums); its gradients stay
# within this many bf16 roundings of each leaf's largest one-device value
GRAD_ROUNDINGS = 2.0


def test_dp_major_loss_and_gradients(ref, world):
    d, out = ref
    cfg = R.config(R.DP_CASE["arch"], R.DP_CASE["capacity"])
    m, params = _one_device(cfg, 4, R.load_tree(d / "dp_params.npz"))
    batch = {"tokens": torch.from_numpy(out["dp_tokens"]),
             "labels": torch.from_numpy(out["dp_labels"])}
    loss, grads = loss_and_grads(m.loss_fn, params, batch)
    for r in range(8):                      # one loss on every rank
        assert world[r]["dpm_loss"] == world[0]["dpm_loss"]
        assert world[r]["base_loss"] == world[0]["base_loss"]
    base, dpm = world[0]["base_loss"], world[0]["dpm_loss"]
    # the reference's own bound, between the layouts and against it
    assert abs(base - dpm) < 1e-2
    assert abs(base - float(out["dp_base_loss"])) < 1e-2
    assert abs(dpm - float(out["dp_dpm_loss"])) < 1e-2
    # the one device's load-balancing term is over the whole batch, the
    # mesh's (as the reference's) the mean of each data row's
    print("losses: base", base, "dpm", dpm, "ref", float(out["dp_base_loss"]),
          float(out["dp_dpm_loss"]), "one device", float(loss))
    # dp-major gathers tokens over model and scatters the sum back
    ops = {(e["op"], tuple(e["axes"])) for e in world[0]["dpm_record"]}
    assert {("all_gather", ("model",)), ("psum_scatter", ("model",)),
            ("all_gather", ("data",))} <= ops
    # the baseline rules split the dense leaves over model (row sums and
    # the vocab-parallel loss) and store them over data by fsdp: gathered
    # a layer at a time, their gradients scattered back
    ops = _calls(world[0]["base_record"])
    assert {("all_gather", ("data",)), ("psum_scatter", ("data",)),
            ("psum", ("model",)), ("pmax", ("model",))} <= set(ops)
    specs = world[0]["base_specs"]
    assert specs["layers/attn/wq"] == (None, "data", "model")
    assert specs["embed/head"] == ("data", "model")
    # the gradients through every collective's adjoint: dp-major's
    # gathers and scatters, and the baseline's psum of partial expert sums
    # over model with x replicated there
    one = {p: g.numpy() for p, g in flatten_with_paths(grads)}
    for layout in ("dpm", "base"):
        got = world[0][f"{layout}_grads"]
        assert sorted(got) == sorted(one)
        worst = {p: _bf16_rounds(got[p], one[p]) for p in one}
        print(layout, worst)
        assert max(worst.values()) <= GRAD_ROUNDINGS, (layout, worst)


# ---------------------------------------------------------------------------
# moe gather mode against ep2d (kimi-k2 reduced, capacity 8, tokens (2, 32))
# ---------------------------------------------------------------------------

def test_moe_gather_mode_against_ep2d(ref, world):
    d, out = ref
    cfg = R.config(R.EP2D_CASE["arch"], R.EP2D_CASE["capacity"])
    m, params = _one_device(cfg, 4, R.load_tree(d / "ep2d_params.npz"))
    with torch.no_grad():
        one = m.prefill(params, {"tokens": torch.from_numpy(
            out["ep2d_tokens"])})[0].float().numpy()
    w = world[0]
    # ep2d splits the experts over model and d_ff over data; gather mode
    # stores d_model over data
    assert w["ep2d_specs"]["layers/moe/wi"] == (None, "model", None, "data")
    assert w["gather_specs"]["layers/moe/wi"] == (None, "model", "data")
    rows = [0, 4]
    ep2d = _rows_by_data(world, "ep2d_logits", rows)
    gather = _rows_by_data(world, "gather_logits", rows)
    assert float(np.abs(ep2d - gather).max()) < 0.1
    for got, key in ((ep2d, "ep2d_ep2d_logits"),
                     (gather, "ep2d_gather_logits")):
        assert float(np.abs(got - out[key]).max()) < 0.1
        assert _bf16_rounds(got, out[key]) <= 2.0
        assert _bf16_rounds(got, one) <= 2.0


# ---------------------------------------------------------------------------
# the multi-pod compressed mean (granite reduced, (2, 2, 2), 2 microbatches)
# ---------------------------------------------------------------------------

def test_multi_pod_gradients_ride_int8_within_one_quantum(ref, world):
    from repro.training.grad_compress import _quantized_pod_mean
    d, out = ref
    rec = world[0]["pod_record"]
    over_pod = [e for e in rec if "pod" in e["axes"]]
    # the gradients cross pods as int8 payloads only: one gather of every
    # leaf packed, the scales' fp32 max, and the loss's fp32 scalar mean
    # (the counterpart of the reference's "s16" in its HLO)
    assert {(e["op"], e["dtype"]) for e in over_pod} == {
        ("all_gather", "int8"), ("pmax", "float32"), ("psum", "float32")}
    for e in over_pod:
        if e["op"] == "psum":
            assert e["bytes"] == 4 * e["calls"]        # the loss, a scalar
        if e["op"] == "pmax":
            assert e["calls"] == 1
    got = world[0]["pod_grads"]
    # each rank's blocks: the dense leaves over (data, model), whole over
    # pod; 2 ways along each axis a spec names
    specs = world[0]["pod_specs"]
    n = sum(g.size // 2 ** len([a for e in specs.get(p, ()) for a in
                                ((e,) if isinstance(e, str) else e or ())])
            for p, g in got.items())
    assert specs["layers/attn/wq"] == (None, "data", "model")
    gather = next(e for e in over_pod if e["op"] == "all_gather")
    assert (gather["calls"], gather["bytes"]) == (1, n)
    assert not any(e["dtype"] == "int16" for e in rec)
    # within one quantum (scale / npods) of the reference's
    # _quantized_pod_mean on the port's stacked per-pod gradients
    equal = total = 0
    for p, g in got.items():
        stacked = np.stack([world[0]["pod_local"][p],
                            world[4]["pod_local"][p]])
        want = np.asarray(_quantized_pod_mean(stacked))
        quantum = max(float(np.abs(stacked).max()), 1e-20) / 127.0 / 2
        assert float(np.abs(g - want).max()) <= quantum, p
        equal += int((g == want).sum())
        total += g.size
    print(f"pod mean: {equal} of {total} values bit-equal to the "
          f"reference's _quantized_pod_mean")
    assert equal / total >= 0.999, equal / total
    # end to end against the reference's step: the per-pod gradients
    # themselves differ by bf16 roundings (each data rank rounds its own
    # rows' bf16 gradients), which moves the scale and the payloads; held
    # to 3 quanta of the reference's scale
    amax = dict(flatten_with_paths(R.load_tree(d / "pod_amax.npz")))
    jgrads = dict(flatten_with_paths(R.load_tree(d / "pod_grads.npz")))
    worst = max(float(np.abs(got[p] - jgrads[p]).max())
                / (max(float(amax[p]), 1e-20) / 127.0 / 2) for p in got)
    print(f"pod mean against the reference's step: {worst:.3f} quanta")
    assert worst <= 3.0, worst
    assert abs(world[0]["pod_loss"] - float(out["pod_loss"])) < 1e-3
    assert world[0]["pod_step_loss"] == world[0]["pod_loss"]
    for r in range(8):                     # every rank holds the same loss
        assert world[r]["pod_loss"] == world[0]["pod_loss"]


# ---------------------------------------------------------------------------
# LMServer on (1, 4) and (2, 2) meshes (dbrx reduced, capacity 8, and
# granite reduced, greedy)
# ---------------------------------------------------------------------------

def test_lmserver_on_four_ranks(monkeypatch, tmp_path):
    _serve_on_four_ranks(monkeypatch, tmp_path, (1, 4), "dbrx-132b")


@pytest.mark.parametrize("shape,arch", [
    ((2, 2), "dbrx-132b"), ((2, 2), "granite-8b"), ((1, 4), "granite-8b")])
def test_lmserver_over_data_and_dense_tp(monkeypatch, tmp_path, shape, arch):
    _serve_on_four_ranks(monkeypatch, tmp_path, shape, arch)


def _serve_on_four_ranks(monkeypatch, tmp_path, shape, arch):
    """Four ranks serve the one device's streams (a stream may part only
    at a near-tie of the one device's logits) with its engine report, the
    mesh aside: on (1, 4) every rank serves every slot, on (2, 2) each
    data row its half of them."""
    ranks = t_mesh.run_ranks(R.world_serve, 4, shape, arch, device="cpu",
                             timeout=120, tmpdir=str(tmp_path))
    cfg = R.serve_config(arch)
    model = build_model(cfg.padded_config(shape[1]), device="cpu")
    params = model.init(torch.Generator().manual_seed(R.SERVE_CASE["seed"]))
    holder = {}
    real = t_engine.LMServer.run

    def run(srv, p, **kw):          # record the one device's logits rows
        holder["logits"] = record_logits(
            monkeypatch, srv, t_engine,
            lambda x, calls: calls.append(x.float().numpy()), lambda: None)
        return real(srv, p, **kw)

    monkeypatch.setattr(t_engine.LMServer, "run", run)
    streams, report, _ = R.serve(model, params, cfg)
    # each rank holds its block of the heads (and on moe of the experts),
    # and the cache of its kv heads of its data row's slots
    one_wq = tuple(params["layers"]["attn"]["wq"].shape)
    for r in ranks:
        assert r["wq"] == one_wq[:2] + (one_wq[2] // shape[1],)
        assert r["cache"][1] == R.SERVE_CASE["slots"] // shape[0]
        assert r["cache"][3] == cfg.padded(shape[1]).num_kv_heads // shape[1]
        if "experts" in r:
            assert r["experts"][1] == cfg.num_experts // shape[1]
        assert r["streams"] == ranks[0]["streams"]
    got = ranks[0]["streams"]
    logits = holder["logits"]
    parted = 0
    for rid, want in streams.items():
        k = next((i for i, (a, b) in enumerate(zip(want, got[rid]))
                  if a != b), None)
        if k is not None:          # only where the one device's best two
            parted += 1            # logits lie within one bf16 ulp
            row = logits[rid][k]
            a, b = want[k], got[rid][k]
            assert row[a] - row[b] <= bf16_ulp(max(abs(row[a]),
                                                   abs(row[b]))), rid
    print(f"LMServer {arch} on {shape}: {len(streams) - parted} of "
          f"{len(streams)} streams equal to one device's")
    # the engine reports the same, but the mesh it names
    rep = dict(ranks[0]["report"])
    assert rep.pop("mesh") == {"shape": dict(zip(("data", "model"), shape)),
                               "backend": "gloo", "staged": False}
    assert rep == report
    ops = _calls(ranks[0]["record"])
    assert ("psum", ("model",)) in ops                 # the row sums
    assert ("all_gather", ("model",)) in ops           # the logits
    assert ("broadcast", ("data", "model")) in ops
    assert ("pmax", ("data", "model")) in ops
    # over data: the rows' tokens summed once a prefill and once a step
    assert (("psum", ("data",)) in ops) == (shape[0] > 1)
    if shape[0] > 1:
        assert ops[("psum", ("data",))] == ops[("broadcast",
                                                ("data", "model"))]


def test_serve_launcher_on_an_elastic_mesh_with_data(tmp_path):
    """``launch.serve`` on the elastic mesh of 4 ranks at a model
    parallelism of 2, (2, 2): its slots rounded up to a multiple of the
    data rows, every request served, the same streams on every rank."""
    argv = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
            "--requests", "5", "--max-new", "4", "--slots", "3"]
    ranks = t_mesh.run_ranks(R.launcher_serve, 4, 2, argv, device="cpu",
                             timeout=120, tmpdir=str(tmp_path))
    for r in ranks:
        assert r["mesh"] == {"data": 2, "model": 2}
        assert r["slots"] == 4
        assert r["streams"] == ranks[0]["streams"]
    assert sorted(ranks[0]["streams"]) == list(range(5))
    assert all(len(t) == 4 for t in ranks[0]["streams"].values())


# ---------------------------------------------------------------------------
# the kernel build, started by several processes at once
# ---------------------------------------------------------------------------

STUB_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
time.sleep(0.3)                       # widen the window two builds share
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
"""


def test_kernel_build_runs_once_across_processes(tmp_path):
    """Two processes that build at once (with ``nvcc`` stubbed) leave one
    library, built by one of them: one compile per source, one link."""
    from repro_torch.kernels import _build
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB_NVCC.format(python=sys.executable, log=str(log)))
    stub.chmod(0o755)
    build_dir = tmp_path / "build"
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(ROOT / "src")!r})
        from repro_torch.kernels import _build as b
        b.BUILD_DIR = Path({str(build_dir)!r})
        b.nvcc_path = lambda: {str(stub)!r}
        print(b.build())
        """)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    lib = Path(paths.pop())
    assert lib.read_text() == "built"
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [lib.name, lib.stem + ".lock"])
    calls = log.read_text().splitlines()
    assert sum(" -c " in c for c in calls) == len(_build.SOURCES)
    assert sum(" -shared " in c for c in calls) == 1


def test_local_slice_and_gather_global_invert_each_other():
    """Without a world a mesh of size-1 axes: every block is the whole
    tensor, and the collectives return their input."""
    from repro_torch.distributed import sharding as sh
    m = t_mesh.make_local_mesh(device="cpu")
    x = torch.arange(24.0).view(2, 3, 4)
    spec = (None, "model", "data")
    assert sh.local_slice(x, spec, m) is not x
    assert torch.equal(sh.local_slice(x, spec, m), x)
    assert torch.equal(sh.gather_global(x, spec, m), x)
    assert torch.equal(sh.psum(x, "model", mesh=m), x)
    assert sh.axis_index("model", mesh=m) == 0
    with pytest.raises(ValueError, match="torch.distributed world"):
        sh.psum(x, "model", mesh=t_mesh.Mesh({"data": 1, "model": 2}))


# ---------------------------------------------------------------------------
# a rank's init: its block of the one-device draw, and no more
# ---------------------------------------------------------------------------

def _rank_mesh(shape, rank):
    """Rank ``rank``'s (data, model) mesh, its coordinates only: enough
    for a model's placement, no world to run collectives on."""
    axes = ("data", "model")
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    world = t_mesh.World(rank=rank, coords=coords, device=torch.device("cpu"),
                         backend="gloo", staged=False, groups={}, members={})
    return t_mesh.Mesh(dict(zip(axes, shape)), (torch.device("cpu"),), world)


class _LargestTensor(TorchDispatchMode):
    """The bytes of the largest tensor any op makes while it is on."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.bytes = max(self.bytes, t.numel() * t.element_size())
        return out


@pytest.mark.parametrize("arch,shape,rules", [
    ("dbrx-132b", (1, 4), {}),
    ("kimi-k2-1t-a32b", (2, 2), {"expert_ffn": "data"}),
    ("kimi-k2-1t-a32b", (2, 2), {"fsdp": "data"}),
    ("granite-8b", (1, 4), {}),
    ("qwen2-7b", (2, 2), {"fsdp": "data"}),
    ("internvl2-1b", (2, 2), {"fsdp": "data"})])
def test_rank_init_draws_only_its_block(arch, shape, rules):
    """``init`` on a rank's model gives its block of the one-device model's
    draw, bit for bit, and never makes the whole of a split leaf: its
    largest tensor is a replicated leaf or one fp32 matrix (an expert's,
    or one layer's of a dense leaf). Every attention, FFN, embedding and
    head leaf is split over ``model`` (and its ``d_model`` dim over
    ``data`` by ``fsdp``); the norms and the router stay whole."""
    from repro_torch.distributed.sharding import block_slices, serve_rules
    cfg = R.config(arch, 8.0 if arch in ("dbrx-132b", "kimi-k2-1t-a32b")
                   else None)
    one = build_model(cfg.padded_config(shape[1]), device="cpu")
    whole = dict(flatten_with_paths(one.init(torch.Generator().manual_seed(3))))
    ranks = shape[0] * shape[1]
    for r in range(ranks):
        mesh = _rank_mesh(shape, r)
        m = build_model(cfg, device="cpu", mesh=mesh,
                        rules=dict(serve_rules(False), **rules))
        specs = m.extras["param_specs"]
        assert sorted(p for p in whole if p not in specs) == sorted(
            p for p in whole if p.endswith(("norm", "ln1", "ln2", "router")))
        with _LargestTensor() as seen:
            got = dict(flatten_with_paths(
                m.init(torch.Generator().manual_seed(3))))
        assert sorted(got) == sorted(whole)
        for path, leaf in got.items():
            want = whole[path]
            if path in specs:
                want = want[block_slices(want.shape, specs[path], mesh)]
                ways = mesh.size([a for e in specs[path]
                                  for a in (e if isinstance(e, tuple)
                                            else (e,)) if a])
                assert "model" in str(specs[path]), path
                assert leaf.numel() * ways == whole[path].numel(), path
                if rules.get("fsdp") and "/moe/" not in path and \
                        not path.endswith(("bq", "bk", "bv")):
                    assert "data" in str(specs[path]), path
            assert torch.equal(leaf, want), path
        matrix = max(int(np.prod(whole[p].shape[-2:])) for p in specs) * 4
        replicated = max(whole[p].numel() for p in whole if p not in specs) * 4
        assert seen.bytes <= max(matrix, replicated), (seen.bytes, matrix,
                                                       replicated)
        assert seen.bytes < max(whole[p].numel() * 4 for p in specs)


def test_full_dbrx_rank_fits_one_card():
    """Unreduced dbrx-132b (40 layers) on a (1, 4) mesh: a rank holds 65.8
    GB, under one card's 80 GB (72.9 GB with its dense leaves whole)."""
    assert 65.8e9 < _full_rank_bytes("dbrx-132b") < 65.9e9


def test_full_smollm_rank_holds_a_quarter():
    """Unreduced smollm-360m on (1, 4): a quarter of its 0.818 GB of
    padded weights, but the norms."""
    assert 0.2045e9 < _full_rank_bytes("smollm-360m") < 0.2055e9


def _full_rank_bytes(arch):
    """The bytes of each rank's init of unreduced ``arch`` on a (1, 4)
    mesh, built on the meta device: a quarter of every split leaf (the
    experts; attention, FFN, embedding and head over ``model``) and the
    whole of the norms and the router."""
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.distributed.sharding import serve_rules
    cfg = ARCHITECTURES[arch]
    meta = torch.device("meta")
    nbytes = lambda m: {p: t.numel() * t.element_size() for p, t in
                        flatten_with_paths(m.init(torch.Generator()))}
    whole = nbytes(build_model(cfg.padded_config(4), device=meta))
    experts = 3 * cfg.num_layers * cfg.num_experts * cfg.d_model * cfg.d_ff
    assert sum(b for p, b in whole.items() if "/moe/w" in p) == experts * 2
    for r in (0, 3):
        world = t_mesh.World(rank=r, coords={"data": 0, "model": r},
                             device=meta, backend="gloo", staged=False,
                             groups={}, members={})
        m = build_model(cfg, device=meta, mesh=t_mesh.Mesh(
            {"data": 1, "model": 4}, (meta,), world),
            rules=serve_rules(False))
        specs = m.extras["param_specs"]
        sizes = nbytes(m)
        assert sorted(sizes) == sorted(whole)
        for p, b in sizes.items():
            assert b * (4 if p in specs else 1) == whole[p], p
        dense = sum(whole[p] for p in specs if "/moe/" not in p)
        kept = sum(whole[p] for p in whole if p not in specs)
        print(f"{arch} rank {r}: {sum(sizes.values()) / 1e9:.3f} GB of "
              f"weights ({experts * 2 / 4e9:.3f} GB of experts, "
              f"{dense / 4e9:.3f} GB of split dense leaves, {kept / 1e9:.4f} "
              f"GB whole); {sum(whole.values()) / 1e9:.3f} GB on one device")
        assert sum(sizes.values()) == (experts * 2 + dense) / 4 + kept
    return sum(sizes.values())


@pytest.mark.parametrize("shape,arch", [
    ((1, 4), "dbrx-132b"), ((1, 4), "granite-8b"), ((2, 2), "granite-8b")])
def test_adafactor_trains_split_leaves(tmp_path, shape, arch):
    """Adafactor on leaves split over ranks (the experts over ``model`` in
    ``ep``; dense TP; on (2, 2) ``fsdp`` over data as well) takes each
    factor, the row normaliser and the update's RMS over the whole leaf:
    on the one device's gradients its update is one device's to fp32
    rounding, and a whole step's params are within ``GRAD_ROUNDINGS`` of
    the one device's step."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.tree import tree_map
    ranks = t_mesh.run_ranks(R.world_adafactor, 4, shape, arch,
                             device="cpu", timeout=120, tmpdir=str(tmp_path))
    cfg, batch = R.adafactor_case(arch)
    one = build_model(cfg.padded_config(shape[1]), device="cpu")
    params = one.init(torch.Generator().manual_seed(0))
    loss, grads = loss_and_grads(one.loss_fn, params, batch)
    p32 = tree_map(lambda t: t.float(), params)
    want, _, _ = opt.adafactor_update(grads, opt.adafactor_init(p32), p32,
                                      lr=R.ADAFACTOR_LR)
    before = dict(flatten_with_paths(p32))
    worst = 0.0
    for path, w in flatten_with_paths(want):
        step = (w - before[path]).numpy()
        got = ranks[0]["opt"][path] - before[path].numpy()
        worst = max(worst, float(np.abs(got - step).max()
                                 / np.abs(step).max()))
    print(f"adafactor on {shape}: updates within {worst:.2e} of the one "
          f"device's largest")
    assert worst <= 1e-5
    step, opt_init = make_train_step(one, TrainConfig(
        optimizer="adafactor", lr=R.ADAFACTOR_LR, warmup_steps=0,
        total_steps=10))
    new, _, metrics = step(params, opt_init(params), batch)
    assert abs(ranks[0]["loss"] - float(metrics["loss"])) < 1e-3
    rounds = {p: _bf16_rounds(ranks[0]["step"][p], w.float().numpy())
              for p, w in flatten_with_paths(new)}
    print(f"a step's params: {max(rounds.values()):.3f} roundings")
    assert max(rounds.values()) <= GRAD_ROUNDINGS, rounds
    # the factors' sums over the splitting axes
    assert ("psum", ("model",)) in _calls(ranks[0]["record"], "float32")


@pytest.mark.parametrize("arch,rules", [
    ("dbrx-132b", {}), ("kimi-k2-1t-a32b", {"expert_ffn": "data"}),
    ("granite-8b", {"seq": "model"})])
def test_one_rank_mesh_is_the_one_device_model(arch, rules):
    """On a (1, 1) mesh without a world the sharded code paths (``ep``,
    ``ep2d``, context-parallel prefill) are the ``tp = 1`` case: the same
    logits and cache as without a mesh, bit for bit."""
    from repro_torch.distributed.sharding import serve_rules
    cfg = R.config(arch, 8.0 if arch != "granite-8b" else None)
    plain = build_model(cfg, device="cpu")
    meshed = build_model(cfg, device="cpu",
                         mesh=t_mesh.make_local_mesh(device="cpu"),
                         rules=dict(serve_rules(False), **rules))
    params = plain.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    with torch.no_grad():
        (l0, c0), (l1, c1) = (m.prefill(params, {"tokens": toks})
                              for m in (plain, meshed))
    assert torch.equal(l0, l1)
    for k in ("k", "v"):
        assert torch.equal(c0[k], c1[k])
