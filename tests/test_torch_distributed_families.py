"""Dense tensor parallelism and ``fsdp`` for hymba, the encoder-decoder and
xlstm, on the CPU: the port as gloo worlds of spawned ranks (the rank
programs are ``tests/_torch_dist_families.py``), the reference in one
subprocess with 8 forced host devices, as ``test_torch_distributed.py``
runs it. Both sides take the reference's ``init`` params (through
``bridge.params_for_rank``) and the same inputs from
``np.random.default_rng(0)``: reduced configs (2 layers, d_model 64) on
(data 2, model 4).

Tolerances, against the reference's 8-device outputs:

* prefill logits: xlstm's bit for bit (its layers stay whole over
  ``model``; the vocab split computes each logit as one device does);
  hymba's within ``DRIFT["hymba-1.5b"]`` and the encoder-decoder's within
  ``DRIFT["seamless-m4t-medium"]`` bf16 roundings of the largest logit,
  their one-device parity tests' bounds (``test_torch_hymba.py``,
  ``test_torch_encdec.py``): the ranks sum their heads' partial products
  in fp32 and round once where one device rounds one product;
* the loss within ``LOSS_TOL``, and each gradient leaf within
  ``GRAD_ROUNDINGS`` bf16 roundings (2**-7) of its largest value, the
  one-device parity bound of ``test_torch_train_parity.py`` (6 roundings
  of 2**-8); hymba's SSD leaves past it (``SSD_LEAVES``: their gradients
  sum long chains of products of the decays, in which one-ulp differences
  of the inputs add up; on these inputs the port's one device is 23
  roundings from the reference on ``g/ssd/d_skip`` and 4 on
  ``g/ssd/conv``) no further from the reference's than ``ANCHOR_RATIO``
  times the port's one device is, on the same params and batch.

Every world starts through a ``file://`` rendezvous under the test's temp
directory and the parent kills a world that outlives its deadline."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_dist_families as F
import _torch_dist_ranks as R
from _torch_ties import bf16_ulp, record_logits
from repro_torch.launch import mesh as t_mesh
from repro_torch.models.api import build_model
from repro_torch.serving import engine as t_engine
from repro_torch.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0 ** -7
DRIFT = {"hymba-1.5b": 3.0, "seamless-m4t-medium": 2.0, "xlstm-125m": 0.0}
LOSS_TOL = 1e-2
GRAD_ROUNDINGS = 3.0
SSD_LEAVES = ("ssd/b_dt", "ssd/d_skip", "ssd/conv")
ANCHOR_RATIO = 2.0

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
sys.path.insert(0, "tests")
from _torch_dist_families import FAMILIES, KEYS, inputs
from repro.configs.registry import ARCHITECTURES, reduced_config
from repro.distributed.sharding import serve_rules, train_rules
from repro.launch.mesh import compat_make_mesh
from repro.models.api import build_model

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


f32 = lambda x: np.asarray(x, np.float32)
mesh = compat_make_mesh((2, 4), ("data", "model"))
for arch in FAMILIES:
    key = KEYS[arch]
    cfg = reduced_config(ARCHITECTURES[arch], num_layers=2, d_model=64)
    pre, train = inputs(arch, cfg.d_model, cfg.vocab_size)
    with mesh:
        m = build_model(cfg, mesh, serve_rules(False))
        params = m.init(jax.random.PRNGKey(1))
        logits, _ = jax.jit(lambda p, b: m.prefill(p, b))(params, pre)
        mt = build_model(cfg, mesh, train_rules(False))
        loss, grads = jax.jit(jax.value_and_grad(mt.loss_fn))(params, train)
    save_tree(f"{key}_params", params)
    save_tree(f"{key}_grads", jax.tree.map(f32, grads))
    outs[f"{key}_logits"] = f32(logits)
    outs[f"{key}_loss"] = f32(loss)
np.savez(f"{out_dir}/outputs.npz", **outs)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's params and outputs, computed once (one JAX start)."""
    d = tmp_path_factory.mktemp("families_ref")
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
    """Every family's case, run once on one world of 8 ranks."""
    return t_mesh.run_ranks(F.world_families, 8, str(ref[0]), device="cpu",
                            timeout=300,
                            tmpdir=str(tmp_path_factory.mktemp("world8")))


def _bf16_rounds(a, b):
    """max |a - b| in bf16 roundings of the largest |b|."""
    return float(np.abs(a - b).max() / (BF16_ULP * np.abs(b).max()))


def _calls(record):
    out = {}
    for e in record:
        key = (e["op"], tuple(e["axes"]))
        out[key] = out.get(key, 0) + e["calls"]
    return out


def _ways(spec, mesh_shape):
    return int(np.prod([mesh_shape[a] for e in spec for a in
                        ((e,) if isinstance(e, str) else e or ())]))


# ---------------------------------------------------------------------------
# against the reference's 8-device run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", F.FAMILIES)
def test_prefill_logits_match_the_reference(ref, world, arch):
    """Each data row's logits (model index 0 of data 0 and 1) against the
    reference's: every model rank of a row holds the same, bit for bit."""
    _, out = ref
    key = F.KEYS[arch]
    for r in range(8):
        assert np.array_equal(world[r][f"{key}_logits"],
                              world[4 * (r // 4)][f"{key}_logits"])
    got = np.concatenate([world[r][f"{key}_logits"] for r in (0, 4)])
    want = out[f"{key}_logits"]
    assert got.shape == want.shape
    rounds = _bf16_rounds(got, want)
    print(f"{arch} prefill on (2, 4): {rounds:.3f} bf16 roundings of the "
          f"reference's largest logit")
    if DRIFT[arch] == 0.0:
        assert np.array_equal(got, want)
    else:
        assert rounds <= DRIFT[arch]
    # the row sums and the logits gathered over the vocab travel over
    # model; nothing crosses data at serve time
    ops = _calls(world[0][f"{key}_serve_record"])
    assert ("all_gather", ("model",)) in ops
    assert not any("data" in axes for _, axes in ops)
    if arch != "xlstm-125m":
        assert ("psum", ("model",)) in ops


def test_encdec_decode_on_ranks(ref, world):
    """The encoder-decoder's decode steps on (2, 4), from its prefill of
    the reference's params: each data row's logits within
    ``DRIFT["seamless-m4t-medium"]`` roundings of the one-device port's
    (padded(4)) at every step, and each rank's cache (self and cross K/V)
    of its kv head and its data row's samples."""
    from repro_torch.bridge import params_from_numpy
    d, _ = ref
    cfg = R.config("seamless-m4t-medium")
    one = build_model(cfg.padded_config(4), device="cpu")
    pre, _ = F.inputs("seamless-m4t-medium", cfg.d_model, cfg.vocab_size)
    want, shapes = F.encdec_decode(
        one, params_from_numpy(R.load_tree(d / "encdec_params.npz"), "cpu"),
        {k: torch.from_numpy(v) for k, v in pre.items()})
    for r in range(8):
        got = world[r]["encdec_decode"]
        assert len(got) == len(want) == F.DECODE_STEPS
        for i, w in enumerate(want):
            half = w.shape[0] // 2
            rows = w[(r // 4) * half:(r // 4 + 1) * half]
            rounds = _bf16_rounds(got[i], rows)
            assert rounds <= DRIFT["seamless-m4t-medium"], (r, i, rounds)
        for k, s in world[r]["encdec_cache"].items():
            if k == "lengths":
                assert s == (shapes[k][0] // 2,)
            else:
                assert s == (shapes[k][0], shapes[k][1] // 2, shapes[k][2],
                             shapes[k][3] // 4, shapes[k][4]), k


@pytest.mark.parametrize("arch", F.FAMILIES)
def test_loss_and_gradients_match_the_reference(ref, world, arch):
    """``train_rules`` on (2, 4): dense TP over ``model`` (xlstm: the vocab
    only) and every dense leaf stored over ``data`` by ``fsdp``, gathered
    a layer at a time and its gradient scattered back."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.training.grad_compress import loss_and_grads
    d, out = ref
    key = F.KEYS[arch]
    for r in range(8):
        assert world[r][f"{key}_loss"] == world[0][f"{key}_loss"]
    assert abs(world[0][f"{key}_loss"] - float(out[f"{key}_loss"])) \
        < LOSS_TOL
    want = dict(flatten_with_paths(R.load_tree(d / f"{key}_grads.npz")))
    got = world[0][f"{key}_grads"]
    assert sorted(got) == sorted(want)
    # the port's one device on the same params and batch: the distance of
    # hymba's SSD leaves from the reference's is its own already
    cfg = R.config(arch)
    one_model = build_model(cfg.padded_config(4), device="cpu")
    _, batch = F.inputs(arch, cfg.d_model, cfg.vocab_size)
    _, g1 = loss_and_grads(one_model.loss_fn, params_from_numpy(
        R.load_tree(d / f"{key}_params.npz"), "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    one = {p: t.float().numpy() for p, t in flatten_with_paths(g1)}
    worst = {}
    for p, w in want.items():
        if not np.abs(w).max():
            assert not np.abs(got[p]).max(), p
            continue
        rounds = _bf16_rounds(got[p], np.asarray(w))
        worst[p] = rounds
        if p.endswith(SSD_LEAVES) and rounds > GRAD_ROUNDINGS:
            anchor = _bf16_rounds(one[p], np.asarray(w))
            print(f"{p}: {rounds:.3f} roundings, the one device {anchor:.3f}")
            assert rounds <= ANCHOR_RATIO * anchor, (p, rounds, anchor)
        else:
            assert rounds <= GRAD_ROUNDINGS, (p, rounds)
    print(f"{arch} gradients on (2, 4): {max(worst.values()):.3f} bf16 "
          f"roundings of the reference's at worst "
          f"({max(worst, key=worst.get)})")
    ops = _calls(world[0][f"{key}_train_record"])
    assert {("all_gather", ("data",)), ("psum_scatter", ("data",)),
            ("pmax", ("model",))} <= set(ops)


# ---------------------------------------------------------------------------
# where the leaves live
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", F.FAMILIES)
def test_every_split_leaf_has_its_share_on_each_rank(ref, world, arch):
    """On (2, 4) every leaf the reference splits has a spec and each rank
    holds exactly its share of it: hymba's and the encoder-decoder's
    attention, FFN, SSD (hymba), embedding and head leaves over ``model``,
    xlstm's embedding and head only; under ``train_rules`` every dense
    leaf's ``fsdp`` dim over ``data`` too. The norms (and xlstm's biases)
    stay whole. Gathered, each rank's leaves are the reference's."""
    d, _ = ref
    key = F.KEYS[arch]
    tree = dict(flatten_with_paths(R.load_tree(d / f"{key}_params.npz")))
    shape = {"data": 2, "model": 4}
    for name in ("serve", "train"):
        for r in range(8):
            specs = world[r][f"{key}_{name}_specs"]
            shapes = world[r][f"{key}_{name}_shapes"]
            assert world[r][f"{key}_{name}_roundtrip"]
            for p, leaf in tree.items():
                n = int(np.prod(leaf.shape))
                if p in specs:
                    assert int(np.prod(shapes[p])) * _ways(
                        specs[p][0], shape) == n, (p, specs[p])
                else:
                    assert shapes[p] == leaf.shape, p
            whole = sorted(p for p in tree if p not in specs)
            if arch == "xlstm-125m":
                split = [p for p in specs if "model" in str(specs[p][0])]
                assert sorted(split) == ["embed/embedding", "embed/head"]
                if name == "serve":
                    assert sorted(specs) == split
            else:
                assert all(p.endswith(("ln", "ln1", "ln2", "ln_x", "ln_attn",
                                       "ln_ssd", "norm")) for p in whole), \
                    whole
                assert all("model" in str(s[0]) for s in specs.values())
            if name == "train":         # every leaf with a d_model dim
                assert all(p.endswith(("ln", "ln1", "ln2", "ln_x",
                                       "ln_attn", "ln_ssd", "norm", "b",
                                       "b_gates", "b_dt", "a_log",
                                       "d_skip", "bq", "bk", "bv", "conv"))
                           or "data" in str(specs[p][0]) for p in tree), key
    if arch == "hymba-1.5b":
        specs = world[0]["hymba_serve_specs"]
        assert specs["g/ssd/w_in"] == ((None, None, "model"), (1, 1, 2))
        assert specs["g/ssd/w_bc"] == ((None, None, "model"), (1, 1, 2))
        assert specs["g/ssd/conv"][1] == ()
        assert world[0]["hymba_train_specs"]["swa/ssd/w_in"] == (
            (None, "data", "model"), (1, 1, 2))


def _rank_mesh(shape, rank):
    """Rank ``rank``'s (data, model) mesh, its coordinates only: enough
    for a model's placement, no world to run collectives on."""
    axes = ("data", "model")
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    world = t_mesh.World(rank=rank, coords=coords, device=torch.device("cpu"),
                         backend="gloo", staged=False, groups={}, members={})
    return t_mesh.Mesh(dict(zip(axes, shape)), (torch.device("cpu"),), world)


@pytest.mark.parametrize("arch", F.FAMILIES)
def test_rank_init_is_its_block_of_the_one_device_draw(arch):
    """``init`` on a rank's model, (1, 4) under ``serve_rules`` and (2, 2)
    with ``fsdp`` over data, gives its block of the one-device model's
    draw bit for bit: hymba's x ‖ z and B ‖ C the blocks of both pieces."""
    from repro_torch.distributed.sharding import block_slices, serve_rules
    cfg = R.config(arch)
    for shape, rules in (((1, 4), {}), ((2, 2), {"fsdp": "data"})):
        one = build_model(cfg.padded_config(shape[1]), device="cpu")
        whole = dict(flatten_with_paths(
            one.init(torch.Generator().manual_seed(3))))
        for r in range(shape[0] * shape[1]):
            mesh = _rank_mesh(shape, r)
            m = build_model(cfg, device="cpu", mesh=mesh,
                            rules=dict(serve_rules(False), **rules))
            specs = m.extras["param_specs"]
            got = dict(flatten_with_paths(
                m.init(torch.Generator().manual_seed(3))))
            assert sorted(got) == sorted(whole)
            for path, leaf in got.items():
                want = whole[path]
                if path in specs:
                    want = want[block_slices(want.shape, specs[path], mesh)]
                assert torch.equal(leaf, want), (r, path)
    if arch == "hymba-1.5b":         # rank 1 of (1, 4): x_1 ‖ z_1
        one = build_model(cfg.padded_config(4), device="cpu")
        w = one.init(torch.Generator().manual_seed(3))["g"]["ssd"]["w_in"]
        m = build_model(cfg, device="cpu", mesh=_rank_mesh((1, 4), 1),
                        rules=serve_rules(False))
        got = m.init(torch.Generator().manual_seed(3))["g"]["ssd"]["w_in"]
        half = w.shape[-1] // 2
        q = half // 4
        assert torch.equal(got, torch.cat([w[..., q:2 * q],
                                           w[..., half + q:half + 2 * q]],
                                          -1))


def test_paired_leaves_round_trip():
    """``local_slice`` and ``gather_dim`` invert each other on a leaf of
    two pieces over the ranks of (2, 2) without a world: each rank's block
    is its share of both pieces, and the model ranks' blocks put side by
    side, as the all-gather gives them, and reordered piece by piece are
    the leaf's data row."""
    from repro_torch.distributed.sharding import (
        PartitionSpec, block_slices, gather_dim, local_slice)
    x = torch.arange(2 * 4 * 16.0).view(2, 4, 16)
    spec = PartitionSpec((None, "data", "model"), parts=(1, 1, 2))
    assert spec == (None, "data", "model") and spec.part(2) == 2
    blocks = {}
    for r in range(4):
        mesh = _rank_mesh((2, 2), r)
        c = mesh.world.coords
        cols = block_slices(x.shape, spec, mesh)[2]
        assert cols == list(range(4 * c["model"], 4 * c["model"] + 4)) + \
            list(range(8 + 4 * c["model"], 12 + 4 * c["model"]))
        blocks[r] = local_slice(x, spec, mesh)
        assert blocks[r].shape == (2, 2, 8)
    for row in (0, 1):
        side = torch.cat([blocks[2 * row], blocks[2 * row + 1]], -1)
        back = side.unflatten(-1, (2, 2, 4)).transpose(-3, -2).flatten(-3)
        assert torch.equal(back, x[:, 2 * row:2 * row + 2])
    # a world of one rank: the block is the whole leaf, the gather nothing
    one = t_mesh.make_local_mesh(device="cpu")
    assert torch.equal(local_slice(x, spec, one), x)
    assert torch.equal(gather_dim(x, "model", 2, parts=2, mesh=one), x)
    with pytest.raises(ValueError, match="does not split"):
        block_slices((2, 4, 16), PartitionSpec((None, None, "model"),
                                               parts=(1, 1, 3)),
                     _rank_mesh((2, 2), 0))


# ---------------------------------------------------------------------------
# LMServer over data with the weights split over data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,fsdp", [
    ("granite-8b", True), ("hymba-1.5b", True), ("hymba-1.5b", False)])
def test_lmserver_over_data_and_model(monkeypatch, tmp_path, arch, fsdp):
    """Four ranks on (data 2, model 2) serve the one device's (padded(2))
    greedy streams, which may part only where the one device's two best
    logits lie within one bf16 ulp, with its engine report but the mesh.
    With ``fsdp`` the weights are stored over data too, so the data rows
    prefill together (each its requests, padding in the others' rows) and
    their collectives over ``data`` pair up; hymba runs at 26 / 2 heads,
    G = 13, decoding on the plain version here."""
    ranks = t_mesh.run_ranks(F.world_serve, 4, arch, fsdp, device="cpu",
                             timeout=180, tmpdir=str(tmp_path))
    cfg = F.serve_config(arch)
    one = build_model(cfg.padded_config(2), device="cpu")
    params = one.init(torch.Generator().manual_seed(R.SERVE_CASE["seed"]))
    holder = {}
    real = t_engine.LMServer.run

    def run(srv, p, **kw):          # record the one device's logits rows
        holder["logits"] = record_logits(
            monkeypatch, srv, t_engine,
            lambda x, calls: calls.append(x.float().numpy()), lambda: None)
        return real(srv, p, **kw)

    monkeypatch.setattr(t_engine.LMServer, "run", run)
    streams, report, _ = R.serve(one, params, cfg)
    whole = dict(flatten_with_paths(params))
    pd = cfg.padded(2)
    if arch == "hymba-1.5b":
        assert pd.num_q_heads // pd.num_kv_heads == 13
    for r in ranks:
        assert r["joint"] == fsdp
        assert r["slots"][1] == R.SERVE_CASE["slots"] // 2
        assert r["streams"] == ranks[0]["streams"]
        # each rank holds its share of every split leaf: a half over
        # model, a quarter where fsdp stores its d_model dim over data
        for p, s in r["shapes"].items():
            spec = r["specs"].get(p, ())
            assert int(np.prod(s)) * _ways(spec, {"data": 2, "model": 2}) \
                == int(np.prod(whole[p].shape)), p
            assert ("model" in str(spec)) == (
                not p.endswith(("norm", "ln", "ln1", "ln2", "ln_attn",
                                "ln_ssd"))), p
        assert any("data" in str(sp) for sp in r["specs"].values()) == fsdp
        k = "kg" if arch == "hymba-1.5b" else "k"
        assert r["cache"][k][1] == R.SERVE_CASE["slots"] // 2
        assert r["cache"][k][3] == pd.num_kv_heads // 2
    got = ranks[0]["streams"]
    parted = 0
    for rid, want in streams.items():
        k = next((i for i, (a, b) in enumerate(zip(want, got[rid]))
                  if a != b), None)
        if k is not None:
            parted += 1
            row = holder["logits"][rid][k]
            a, b = want[k], got[rid][k]
            assert row[a] - row[b] <= bf16_ulp(max(abs(row[a]),
                                                   abs(row[b]))), rid
    print(f"LMServer {arch} on (2, 2), fsdp {fsdp}: "
          f"{len(streams) - parted} of {len(streams)} streams equal to one "
          f"device's")
    rep = dict(ranks[0]["report"])
    assert rep.pop("mesh") == {"shape": {"data": 2, "model": 2},
                               "backend": "gloo", "staged": False}
    assert rep == report
    ops = _calls(ranks[0]["record"])
    assert (("all_gather", ("data",)) in ops) == fsdp  # the weights' gathers
    assert ops[("psum", ("data",))] == ops[("broadcast", ("data", "model"))]


def test_slot_layout_over_data():
    """Over (2, 2) the slots split over ``data``; a model that splits its
    weights over ``data`` (``fsdp`` there) makes the rows prefill
    together, one that does not lets each prefill alone; slots that do not
    split are refused, and so is the reference loop over ``data``."""
    from repro_torch.distributed.sharding import serve_rules
    for fsdp in ("data", None):
        m = build_model(R.config("granite-8b"), device="cpu",
                        mesh=_rank_mesh((2, 2), 3),
                        rules=dict(serve_rules(False), fsdp=fsdp))
        layout = t_engine.SlotLayout(m, m.extras["mesh"], 4)
        assert (layout.data_axes, layout.lo, layout.per_row) == (
            ("data",), 2, 2)
        assert layout.joint == (fsdp == "data")
        with pytest.raises(ValueError, match="do not split"):
            t_engine.SlotLayout(m, m.extras["mesh"], 3)
    m = build_model(R.config("granite-8b"), device="cpu",
                    mesh=_rank_mesh((1, 4), 0),
                    rules=dict(serve_rules(False), fsdp="data"))
    assert not t_engine.SlotLayout(m, m.extras["mesh"], 4).joint
    with pytest.raises(NotImplementedError, match="fused=False"):
        t_engine.LMServer(build_model(
            R.config("granite-8b"), device="cpu", mesh=_rank_mesh((2, 2), 0),
            rules=serve_rules(False)), device="cpu", slots=4, fused=False)


@pytest.mark.parametrize("model_parallelism", [4, 2])
def test_serve_launcher_serves_hymba_on_an_elastic_mesh(tmp_path,
                                                        model_parallelism):
    """``launch.serve`` serves reduced hymba on 4 ranks, on the elastic
    mesh (1, 4) and (data 2, model 2): every request served, the same
    streams on every rank."""
    argv = ["--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
            "--requests", "5", "--max-new", "4", "--slots", "4"]
    ranks = t_mesh.run_ranks(R.launcher_serve, 4, model_parallelism, argv,
                             device="cpu", timeout=120, tmpdir=str(tmp_path))
    for r in ranks:
        assert r["mesh"] == {"data": 4 // model_parallelism,
                             "model": model_parallelism}
        assert r["streams"] == ranks[0]["streams"]
    assert sorted(ranks[0]["streams"]) == list(range(5))
    assert all(len(t) == 4 for t in ranks[0]["streams"].values())


# ---------------------------------------------------------------------------
# the training launcher on an elastic mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", F.FAMILIES)
def test_train_launcher_on_an_elastic_mesh(tmp_path, arch):
    """``launch.train`` on 4 ranks at a model parallelism of 2, (data 2,
    model 2), ``train_rules``: every rank logs the same finite losses and
    holds its block of the vocab-split embedding (and, by ``fsdp``, of
    ``d_model``)."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "32", "--microbatches", "1"]
    ranks = t_mesh.run_ranks(F.launcher_train, 4, arch, argv, device="cpu",
                             timeout=180, tmpdir=str(tmp_path))
    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    cfg = reduced_config(ARCHITECTURES[arch], num_layers=6, d_model=256,
                         vocab_size=4096)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        assert all(np.isfinite(r["losses"]))
        assert r["embedding"] == (cfg.padded(2).vocab_size // 2, 256 // 2)
