"""``repro_torch.launch.dryrun`` and ``launch.roofline`` against the JAX
package, on the CPU.

The dry run counts each cell on the meta device, on one device or on a
counting rank of a mesh; here every family runs reduced, at small shapes.
Its records carry the reference's keys (read from the reference's source:
importing ``repro.launch.dryrun`` would force 512 host devices on JAX),
with ``trace_s`` in place of ``lower_s`` and ``compile_s``; the
arguments' bytes equal the reference's compiled ``memory_analysis()``
exactly, on one device and per device of a (2, 4) mesh (the reference in
a subprocess with 8 forced host devices); the two extrapolations (the ssm
family's length, a train step's microbatch count) equal direct counts, on
one device and on a rank; the roofline's analytic terms equal the
reference's for all 32 cells."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import ARCHITECTURES as J_ARCHITECTURES
from repro.configs.registry import reduced_config as j_reduced_config
from repro.launch import roofline as j_roofline
from repro.launch import steps as j_steps
from repro.launch.mesh import compat_make_mesh
from repro_torch.configs.base import (
    SHAPES_BY_NAME, ShapeSpec, applicable_shapes,
)
from repro_torch.configs.registry import (
    ARCHITECTURES, all_cells, reduced_config,
)
from repro_torch.distributed.sharding import block_extent, block_slices
from repro_torch.launch import dryrun, hlo_stats, roofline
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.steps import build_step
from repro_torch.models.api import build_model
from repro_torch.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("smollm-360m", "dbrx-132b", "internvl2-1b", "xlstm-125m",
            "hymba-1.5b", "seamless-m4t-medium")
# each registry shape cut to a small one of its kind
SMALL = {"train_4k": ShapeSpec("train_4k", 64, 4, "train"),
         "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
         "decode_32k": ShapeSpec("decode_32k", 64, 4, "decode"),
         "long_500k": ShapeSpec("long_500k", 256, 1, "decode")}


def _reference_record_keys():
    """(top-level keys, memory_analysis keys, cost_analysis keys) of a
    successful record of ``src/repro/launch/dryrun.py``."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    top, nested = set(), {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if "arch" in keys or "lower_s" in keys:
                top.update(keys)
                for k, v in zip(node.keys, node.values):
                    if isinstance(v, ast.Dict):
                        nested[k.value] = {kk.value for kk in v.keys}
    assert {"arch", "ok", "lower_s", "memory_analysis", "hlo"} <= top
    return top, nested["memory_analysis"], nested["cost_analysis"]


def _cell(arch, shape_name, **kw):
    return dryrun.run_cell(arch, shape_name, verbose=False,
                           cfg=reduced_config(ARCHITECTURES[arch]),
                           shape=SMALL[shape_name], **kw)


@pytest.mark.parametrize("arch", FAMILIES)
def test_records_have_the_references_keys(arch):
    top, mem, cost = _reference_record_keys()
    want = (top - {"lower_s", "compile_s"}) | {"trace_s", "renamed", "chips",
                                               "fits", "capacity_bytes",
                                               "extrapolated"}
    for shape in applicable_shapes(ARCHITECTURES[arch]):
        rec = _cell(arch, shape.name, capacity=80e9)
        assert rec["ok"], rec.get("traceback")
        assert set(rec) == want, (shape.name, set(rec) ^ want)
        assert set(rec["memory_analysis"]) == mem
        assert set(rec["cost_analysis"]) == cost
        assert rec["chips"] == rec["devices"] == 1 and rec["fits"] is True
        assert rec["renamed"] == {"lower_s": "trace_s",
                                  "compile_s": "trace_s"}
        hlo = rec["hlo"]
        assert hlo["dot_flops"] > 0 and hlo["unknown_trip_whiles"] == 0
        assert hlo["total_collective_bytes"] == 0.0
        assert rec["cost_analysis"]["flops_body_once"] >= hlo["dot_flops"]
        json.dumps(rec)
        cell = roofline.cell_from_record(rec)
        assert cell.t_compute > 0 and cell.t_memory > 0 and cell.t_coll == 0


def test_fits_compares_arguments_and_temp_with_the_capacity():
    rec = _cell("smollm-360m", "decode_32k", capacity=1e12)
    need = (rec["memory_analysis"]["argument_bytes"]
            + rec["memory_analysis"]["temp_bytes"])
    assert rec["fits"]
    assert _cell("smollm-360m", "decode_32k", capacity=need)["fits"]
    assert not _cell("smollm-360m", "decode_32k", capacity=need - 1)["fits"]


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_argument_bytes_equal_the_references(kind):
    """Reduced smollm-360m on a 1 x 1 mesh: the record's argument bytes
    equal the reference's compiled ``argument_size_in_bytes`` exactly."""
    name = {"decode": "decode_32k", "train": "train_4k"}[kind]
    s = SMALL[name]
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    with mesh:
        jb = j_steps.build_step(j_reduced_config(J_ARCHITECTURES[
            "smollm-360m"]), JShapeSpec(s.name, s.seq_len, s.global_batch,
                                        s.kind), mesh)
        want = jb.fn.lower(*jb.arg_specs).compile().memory_analysis()
    rec = _cell("smollm-360m", name)
    assert rec["memory_analysis"]["argument_bytes"] == \
        want.argument_size_in_bytes
    assert rec["meta"] == jb.meta


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_ssm_extrapolation_equals_a_direct_count(kind):
    """Reduced xlstm-125m counted at 1536 tokens directly, and on the line
    through its counts at 512 and 1024: equal, memory included."""
    cfg = reduced_config(ARCHITECTURES["xlstm-125m"])
    shape = ShapeSpec("s", 1536, 2, kind)
    got, how = dryrun.count_cell(cfg, shape, {})
    assert how == {"seq_len": list(dryrun.SSM_LENGTHS)}
    direct = dryrun._count(cfg, shape, {"num_microbatches": 1}
                           if kind == "train" else {})
    assert got.to_dict() == direct.to_dict()
    assert got.memory == direct.memory


def test_microbatch_extrapolation_equals_a_direct_count():
    """Reduced smollm-360m's train step with 5 microbatches, counted
    directly and on the line through 2 and 3 microbatches: equal."""
    cfg = reduced_config(ARCHITECTURES["smollm-360m"])
    shape = ShapeSpec("t", 64, 10, "train")
    got, how = dryrun.count_cell(cfg, shape, {"num_microbatches": 5})
    assert how == {"num_microbatches": [2, 3]}
    direct = dryrun._count(cfg, shape, {"num_microbatches": 5})
    assert got.to_dict() == direct.to_dict()
    assert got.memory == direct.memory


def test_analytic_terms_equal_the_references():
    """``ideal_bytes_per_chip`` and ``model_flops_per_chip`` for all 32
    cells at 1, 256 and 512 chips."""
    cells = list(all_cells())
    assert len(cells) == 32
    for cfg, shape in cells:
        for chips in (1, 256, 512):
            for fn in ("ideal_bytes_per_chip", "model_flops_per_chip"):
                assert (getattr(roofline, fn)(cfg.name, shape.name, chips)
                        == getattr(j_roofline, fn)(cfg.name, shape.name,
                                                   chips)), (cfg.name, fn)
        cut = dataclasses.replace(shape, global_batch=max(
            1, shape.global_batch // 4))
        assert roofline.ideal_time(cfg.name, cut) > 0


def test_kernel_bound_sums_each_dtype_over_its_peak():
    from repro_torch.kernels import Work
    t, by = roofline.kernel_bound(Work(0, {"bf16": 989e9, "f32": 67e9}))
    assert by == "operations" and t == pytest.approx(2.0)
    t, by = roofline.kernel_bound(Work(3.35e9, {"bf16": 1.0}))
    assert by == "bytes" and t == pytest.approx(1.0)


def test_cli_writes_records_that_the_roofline_reads(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --mesh one`` on two full-width
    decode cells (meta: seconds), then ``python -m repro_torch.launch.
    roofline --mesh one`` on its output."""
    assert dryrun.main(["--mesh", "one", "--arch", "xlstm-125m", "--shape",
                        "decode_32k,long_500k", "--out", str(tmp_path)]) == 0
    paths = sorted((tmp_path / "baseline").glob("*.json"))
    assert [p.name for p in paths] == [
        "xlstm-125m__decode_32k__one.json",
        "xlstm-125m__long_500k__one.json"]
    rec = json.loads(paths[0].read_text())
    assert rec["ok"] and rec["fits"] and rec["mesh"] == "1x1"
    assert dryrun.main(["--mesh", "one", "--arch", "xlstm-125m", "--shape",
                        "decode_32k", "--out", str(tmp_path)]) == 0
    assert "1 cached" in capsys.readouterr().out
    roofline.main(["--dryrun", str(tmp_path / "baseline"), "--mesh", "one",
                   "--json", str(tmp_path / "roof.json")])
    out = capsys.readouterr().out
    assert "| xlstm-125m | decode_32k |" in out
    rows = json.loads((tmp_path / "roof.json").read_text())
    assert [r["shape"] for r in rows] == ["decode_32k", "long_500k"]
    assert all(r["dominant"] == "memory" for r in rows)
    assert hlo_stats.HloStats().to_dict()["dot_flops"] == 0.0


# ---------------------------------------------------------------------------
# a rank of a mesh
# ---------------------------------------------------------------------------

REFERENCE_24 = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.configs.base import ShapeSpec
from repro.configs.registry import ARCHITECTURES, reduced_config
from repro.launch import steps
from repro.launch.mesh import compat_make_mesh

cfg = reduced_config(ARCHITECTURES["smollm-360m"])
mesh = compat_make_mesh((2, 4), ("data", "model"))
out = {}
for name, args in json.loads(sys.argv[1]).items():
    with mesh:
        b = steps.build_step(cfg, ShapeSpec(name, *args), mesh)
        ma = b.fn.lower(*b.arg_specs).compile().memory_analysis()
    out[name] = {"argument_bytes": int(ma.argument_size_in_bytes),
                 "meta": b.meta}
print("REFERENCE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_24():
    """The reference's per-device argument bytes and step meta of reduced
    smollm-360m's decode_32k and train_4k cells (``SMALL``) on (data 2,
    model 4), compiled once in a subprocess with 8 forced host devices."""
    cells = {n: [SMALL[n].seq_len, SMALL[n].global_batch, SMALL[n].kind]
             for n in ("decode_32k", "train_4k")}
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": str(Path.home())}
    if os.environ.get("JAX_PLATFORMS"):
        env["JAX_PLATFORMS"] = os.environ["JAX_PLATFORMS"]
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_24),
                        json.dumps(cells)], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=600)
    line = [x for x in r.stdout.splitlines() if x.startswith("REFERENCE ")]
    assert r.returncode == 0 and line, r.stderr[-3000:]
    return json.loads(line[0][len("REFERENCE "):])


@pytest.mark.parametrize("name", ["decode_32k", "train_4k"])
def test_rank_argument_bytes_equal_the_references_per_device(ref_24, name):
    """Reduced smollm-360m on (data 2, model 4): the counting rank's
    argument bytes equal the reference's compiled per-device
    ``argument_size_in_bytes`` exactly: its blocks of the weights and the
    optimizer state, its cache, and its own rows of the batch (rows that
    were a view of the global batch would be charged the whole batch)."""
    cfg = reduced_config(ARCHITECTURES["smollm-360m"])
    mesh = make_rank_mesh((2, 4), ("data", "model"), {"data": 0, "model": 0})
    stats, how = dryrun.count_cell(cfg, SMALL[name], {}, mesh)
    assert how is None
    assert stats.memory["argument_bytes"] == ref_24[name]["argument_bytes"]
    assert build_step(cfg, SMALL[name], mesh).meta == ref_24[name]["meta"]


RANK = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_ssm_extrapolation_on_a_rank_equals_a_direct_count(kind):
    """Reduced xlstm-125m at 1536 tokens on the origin rank of (data 2,
    model 2): the line through its counts at 512 and 1024 tokens is the
    direct count, collectives and memory included."""
    cfg = reduced_config(ARCHITECTURES["xlstm-125m"])
    mesh = make_rank_mesh((2, 2), ("data", "model"), {"data": 0, "model": 0})
    shape = ShapeSpec("s", 1536, 2, kind)
    got, how = dryrun.count_cell(cfg, shape, {}, mesh)
    assert how == {"seq_len": list(dryrun.SSM_LENGTHS)}
    direct = dryrun._count(cfg, shape, {"num_microbatches": 1}
                           if kind == "train" else {}, mesh)
    assert direct.collective_payload
    assert got.to_dict() == direct.to_dict()
    assert got.memory == direct.memory


@pytest.mark.parametrize("coords", [{"pod": 0, "data": 0, "model": 0},
                                    {"pod": 1, "data": 1, "model": 1}])
def test_microbatch_extrapolation_on_a_rank_equals_a_direct_count(coords):
    """Reduced smollm-360m's train step with 5 microbatches on a rank of
    (pod 2, data 2, model 2), its int8 cross-pod mean included: the line
    through 2 and 3 microbatches is the direct count."""
    cfg = reduced_config(ARCHITECTURES["smollm-360m"])
    mesh = make_rank_mesh((2, 2, 2), ("pod", "data", "model"), coords)
    shape = ShapeSpec("t", 64, 20, "train")
    got, how = dryrun.count_cell(cfg, shape, {"num_microbatches": 5}, mesh)
    assert how == {"num_microbatches": [2, 3]}
    direct = dryrun._count(cfg, shape, {"num_microbatches": 5}, mesh)
    assert "all_gather/pod/int8" in direct.collective_payload
    assert got.to_dict() == direct.to_dict()
    assert got.memory == direct.memory


def test_a_train_cell_takes_the_meshs_microbatches():
    """On a rank the microbatch count is ``build_train_step``'s:
    ``suggest_microbatches`` over data x pod, not over one device."""
    from repro_torch.configs.base import suggest_microbatches
    cfg = ARCHITECTURES["hymba-1.5b"]
    shape = SHAPES_BY_NAME["train_4k"]
    for mesh, dp in (("single", 16), ("multi", 32)):
        where = dryrun.cell_mesh(mesh)
        want = suggest_microbatches(cfg, shape, dp)
        assert want != suggest_microbatches(cfg, shape, 1)
        assert build_step(cfg, shape, where).meta["num_microbatches"] == want


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_full_width_rank_holds_its_own_blocks_and_rows(mesh):
    """smollm-360m x decode_32k on a counting rank of each production mesh,
    at full width on meta: ``ok`` and ``fits``, collectives counted, and
    its argument bytes exactly its blocks of the padded weights
    (``block_slices`` of each leaf's spec), its cache (its 8 of the 128
    slots, its kv heads) and its own rows of tokens and lengths."""
    rec = dryrun.run_cell("smollm-360m", "decode_32k", mesh=mesh,
                          verbose=False, capacity=80e9)
    assert rec["ok"] and rec["fits"], rec.get("traceback")
    (shape, axes) = RANK[mesh]
    assert rec["mesh"] == dryrun.MESH_NAMES[mesh]
    assert rec["devices"] == rec["chips"] == int(np.prod(shape))
    assert rec["rank_coords"] == dict.fromkeys(axes, 0)
    assert rec["hlo"]["total_collective_bytes"] > 0
    cfg = ARCHITECTURES["smollm-360m"]
    where = dryrun.cell_mesh(mesh)
    bundle = build_step(cfg, SHAPES_BY_NAME["decode_32k"], where)
    specs = bundle.model.extras["param_specs"]
    whole = dict(flatten_with_paths(build_model(
        cfg.padded_config(16), device="meta").init(torch.Generator())))
    weights = 0
    for path, leaf in whole.items():
        n = leaf.numel()
        if path in specs:
            n = int(np.prod([block_extent(b) for b in block_slices(
                leaf.shape, specs[path], where)]))
        weights += n * leaf.element_size()
    slots = 128 // int(np.prod(shape[:-1]))
    cache = bundle.model.init_cache(slots, 32768)
    nbytes = lambda t: t.numel() * t.element_size()
    # the step takes the lengths as an argument of their own and never
    # reads the cache's, so those go uncounted, as XLA drops an unused one
    cache_bytes = sum(nbytes(t) for k, t in cache.items() if k != "lengths")
    rows = slots * 4 + slots * 4                 # int32 tokens and lengths
    assert rec["memory_analysis"]["argument_bytes"] == \
        weights + cache_bytes + rows
    k = cache["k"]
    assert k.shape[1] == slots and weights < sum(
        nbytes(t) for t in whole.values()) / 8


def test_cli_counts_a_rank_of_both_meshes(tmp_path, capsys):
    """``--mesh both`` (the default) writes a ``__single`` and a ``__multi``
    record per cell, and ``roofline --mesh single`` / ``multi`` reads them
    with T_coll priced by the link rule."""
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    paths = sorted((tmp_path / "baseline").glob("*.json"))
    assert [p.name for p in paths] == [
        "smollm-360m__decode_32k__multi.json",
        "smollm-360m__decode_32k__single.json"]
    for p, mesh in zip(paths, ("pod2x16x16", "16x16")):
        rec = json.loads(p.read_text())
        assert rec["ok"] and rec["mesh"] == mesh
        cell = roofline.cell_from_record(rec)
        by_axes = rec["hlo"]["collective_bytes_by_axes"]
        assert cell.t_coll == pytest.approx(sum(by_axes.values())
                                            / roofline.NET_BW)
        assert cell.chips == rec["devices"]
    capsys.readouterr()
    for mesh in ("single", "multi"):
        roofline.main(["--dryrun", str(tmp_path / "baseline"), "--mesh",
                       mesh])
        assert "| smollm-360m | decode_32k |" in capsys.readouterr().out


def test_link_rule_prices_a_group_by_the_slowest_link_it_crosses():
    """Ranks row-major, 8 to a node: a group inside one node rides NVLink,
    one that spans two nodes the network; every group of the production
    meshes spans nodes."""
    bw = roofline.link_bw
    assert bw({"data": 2, "model": 4}, ("model",)) == roofline.LINK_BW
    assert bw({"data": 2, "model": 4}, ("data",)) == roofline.LINK_BW
    assert bw({"data": 4, "model": 4}, ("data",)) == roofline.NET_BW
    assert bw({"data": 2, "model": 8}, ("model",)) == roofline.LINK_BW
    assert bw({"data": 2, "model": 8}, ("data", "model")) == roofline.NET_BW
    for shape in (roofline.MESH_SHAPES["16x16"],
                  roofline.MESH_SHAPES["pod2x16x16"]):
        for ax in ("pod", "data", "model"):
            if ax in shape:
                assert bw(shape, (ax,)) == roofline.NET_BW
    hlo = {"collective_bytes_by_axes": {"model": 450e9, "data": 50e9}}
    assert roofline.collective_time(hlo, {"data": 2, "model": 4}) == \
        pytest.approx(1.0 + 50e9 / 450e9)
    assert roofline.collective_time(hlo, {"data": 16, "model": 16}) == \
        pytest.approx(10.0)
