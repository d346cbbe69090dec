"""Sharding rules, spec construction, batch-divisibility fitting and the
meshes: ``repro_torch.distributed.sharding``, ``launch.mesh`` and the rule
functions of ``launch.steps`` against the JAX package.

The reference's rule functions read only a mesh's ``shape`` and
``axis_names``, so a stand-in with those two serves as its production
meshes here (16 x 16 and 2 x 16 x 16 would need 256 and 512 devices)."""

from collections import OrderedDict
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_parity import FAMILY_CONFIGS, configs, mesh_rules

from repro.configs.registry import all_cells as j_all_cells
from repro.distributed import sharding as j_sharding
from repro.launch import steps as j_steps
from repro.models.api import build_model as jax_build_model
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import ARCHITECTURES, all_cells
from repro_torch.distributed.sharding import (
    PartitionSpec, ShardingContext, current, norm_axes, params_shardings,
    serve_rules, shard, sharding_context, strip_pod, train_rules,
)
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.steps import fit_batch_sharding, rules_for

MESHES = {"local": ((1, 1), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = (("train", None), ("serve", None), ("serve", "2d"),
         ("serve", "gather"))


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(shape=OrderedDict(zip(axes, shape)),
                           axis_names=axes)


def _port_mesh(name):
    shape, axes = MESHES[name]
    return t_mesh.Mesh(dict(zip(axes, shape)))


@pytest.fixture(scope="module")
def mesh11():
    return t_mesh.make_local_mesh(device="cpu")


# ---- the cases of tests/test_sharding.py, on the port ----

def test_spec_dedupes_repeated_mesh_axes(mesh11):
    rules = {"expert": "model", "fsdp": "data", "expert_ffn": "data"}
    ctx = ShardingContext(mesh11, rules)
    # fsdp and expert_ffn both map to data: second occurrence dropped
    spec = ctx.spec(("expert", "fsdp", "expert_ffn"))
    assert spec == PartitionSpec(("model", "data"))
    assert tuple(spec) == tuple(P("model", "data"))


def test_spec_trailing_nones_trimmed(mesh11):
    ctx = ShardingContext(mesh11, train_rules(False))
    assert tuple(ctx.spec(("batch", None, None))) == tuple(P(("data",)))


def test_strip_pod():
    r = train_rules(True)
    assert r["batch"] == ("pod", "data")
    s = strip_pod(r)
    assert s["batch"] == ("data",)
    assert s["users"] == ("data",)


def test_serve_rules_replicate_fsdp():
    assert serve_rules(False)["fsdp"] is None
    assert train_rules(False)["fsdp"] == "data"
    assert serve_rules(False, shard_experts_2d=True)["expert_ffn"] == "data"


def test_fit_batch_sharding_drops_axes(mesh11):
    out = fit_batch_sharding(dict(train_rules(False)), mesh11, 1)
    assert out["batch"] == ("data",)


def test_padding_rules_all_archs():
    """Every arch's padded dims divide cleanly by tp=16 (the dry-run mesh)."""
    for name, cfg in ARCHITECTURES.items():
        pd = cfg.padded(16)
        assert pd.num_q_heads % 16 == 0 or pd.num_q_heads % pd.num_kv_heads == 0
        assert pd.num_q_heads % pd.num_kv_heads == 0, name
        assert pd.vocab_size % 16 == 0, name
        assert pd.num_kv_heads % 16 == 0 or 16 % pd.num_kv_heads == 0, name
        assert pd.num_q_heads >= cfg.num_heads
        assert pd.vocab_size >= cfg.vocab_size


def test_padded_tp1_is_logical():
    for cfg in ARCHITECTURES.values():
        pd = cfg.padded(1)
        assert pd.num_q_heads == cfg.num_heads
        assert pd.num_kv_heads == cfg.num_kv_heads


def test_cell_accounting():
    """40 nominal cells; 8 long_500k skipped for full-attention archs."""
    cells = list(all_cells())
    assert len(cells) == 32
    long_archs = {c.name for c, s in cells if s.name == "long_500k"}
    assert long_archs == {"xlstm-125m", "hymba-1.5b"}


# ---- the port against the reference ----

@pytest.mark.parametrize("multi_pod", [False, True])
def test_rule_tables_match_reference(multi_pod):
    assert train_rules(multi_pod) == j_sharding.train_rules(multi_pod)
    for two_d in (False, True):
        assert (serve_rules(multi_pod, two_d)
                == j_sharding.serve_rules(multi_pod, two_d))
    for rules in (train_rules(multi_pod), serve_rules(multi_pod)):
        assert strip_pod(rules) == j_sharding.strip_pod(rules)
    for v in (None, "data", ("pod", "data")):
        assert norm_axes(v) == j_sharding.norm_axes(v)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_for_and_fit_batch_sharding_match_reference(mesh):
    """``rules_for`` then ``fit_batch_sharding``, value for value, for
    every cell of ``all_cells()``, each kind and moe mode, on this mesh."""
    ref_mesh, port_mesh = _ref_mesh(mesh), _port_mesh(mesh)
    cells = list(j_all_cells())
    assert len(cells) == 32
    for cfg, shape in cells:
        tcfg = ARCHITECTURES[cfg.name]
        for kind, moe_mode in KINDS:
            multi_pod = "pod" in ref_mesh.shape
            want = j_steps.rules_for(cfg, kind, multi_pod, moe_mode=moe_mode)
            got = rules_for(tcfg, kind, multi_pod, moe_mode=moe_mode)
            assert got == want, (cfg.name, kind, moe_mode)
            for batch in (shape.global_batch, 1, 3, 48):
                assert (fit_batch_sharding(got, port_mesh, batch)
                        == j_steps.fit_batch_sharding(want, ref_mesh, batch)
                        ), (cfg.name, shape.name, kind, batch)


@pytest.mark.parametrize("name", ["g2", "x8", "h2"] + sorted(FAMILY_CONFIGS))
def test_specs_match_reference_param_axes(name):
    """For every leaf of a reduced family's reference ``param_axes``, the
    port's spec equals ``tuple(PartitionSpec)`` of the reference's, under
    each rule table and mesh; ``params_shardings`` maps the whole tree."""
    jc, _ = configs(name)
    jmesh, jrules = mesh_rules()
    axes_tree = jax_build_model(jc, jmesh, jrules).param_axes
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in x)
    leaves = jax.tree.leaves(axes_tree, is_leaf=is_axes)
    assert leaves
    for mesh in sorted(MESHES):
        for rules in (train_rules("pod" in MESHES[mesh][1]),
                      serve_rules("pod" in MESHES[mesh][1], True)):
            ref = j_sharding.ShardingContext(_ref_mesh(mesh), rules)
            port = ShardingContext(_port_mesh(mesh), rules)
            for axes in leaves:
                assert tuple(port.spec(axes)) == tuple(ref.spec(axes)), axes
            got = jax.tree.leaves(params_shardings(axes_tree, port),
                                  is_leaf=lambda x: isinstance(
                                      x, PartitionSpec))
            assert [tuple(s) for s in got] == [tuple(ref.spec(a))
                                               for a in leaves]


def test_shard_is_identity_and_context_is_thread_local(mesh11):
    import threading
    x = torch.ones(3)
    assert current() is None
    with sharding_context(mesh11, train_rules(False)) as ctx:
        assert current() is ctx
        assert shard(x, "batch") is x
        assert ctx.sharding(("batch", "embed")) == PartitionSpec((("data",),))
        seen = []
        t = threading.Thread(target=lambda: seen.append(current()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [None]
    assert current() is None
    assert shard(x, "batch", None) is x


def test_meshes():
    prod = t_mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.devices == ()
    multi = t_mesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert list(multi.shape.values()) == [2, 16, 16]
    local = t_mesh.make_local_mesh(device="meta")
    assert local.shape == {"data": 1, "model": 1}
    assert local.devices == (torch.device("meta"),)
    assert t_mesh.make_elastic_mesh(device="cpu").shape == {"data": 1,
                                                          "model": 1}
    with pytest.raises(ValueError, match="devices"):
        t_mesh.make_local_mesh(2, 1, device="cpu")


def test_meshes_default_to_the_card(monkeypatch):
    """Entry points run on the card: without one the defaults raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (t_mesh.make_local_mesh, t_mesh.make_elastic_mesh):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_production_shapes_cover_every_cell():
    assert {s.name for _, s in all_cells()} == set(SHAPES_BY_NAME)
