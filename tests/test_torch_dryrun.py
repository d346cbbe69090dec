"""``repro_torch.launch.dryrun`` and ``launch.roofline`` against the JAX
package, on the CPU.

The dry run counts each cell on the meta device; here every family runs
reduced, at small shapes. Its records carry the reference's keys (read
from the reference's source: importing ``repro.launch.dryrun`` would force
512 host devices on JAX), with ``trace_s`` in place of ``lower_s`` and
``compile_s``; the arguments' bytes equal the reference's compiled
``memory_analysis()`` exactly; the two extrapolations (the ssm family's
length, a train step's microbatch count) equal direct counts; the
roofline's analytic terms equal the reference's for all 32 cells."""

import ast
import dataclasses
import json
from pathlib import Path

import pytest

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import ARCHITECTURES as J_ARCHITECTURES
from repro.configs.registry import reduced_config as j_reduced_config
from repro.launch import roofline as j_roofline
from repro.launch import steps as j_steps
from repro.launch.mesh import compat_make_mesh
from repro_torch.configs.base import ShapeSpec, applicable_shapes
from repro_torch.configs.registry import (
    ARCHITECTURES, all_cells, reduced_config,
)
from repro_torch.launch import dryrun, hlo_stats, roofline

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
    """``python -m repro_torch.launch.dryrun`` on two full-width decode
    cells (meta: seconds), then ``python -m repro_torch.launch.roofline``
    on its output."""
    assert dryrun.main(["--arch", "xlstm-125m", "--shape",
                        "decode_32k,long_500k", "--out", str(tmp_path)]) == 0
    paths = sorted((tmp_path / "baseline").glob("*.json"))
    assert [p.name for p in paths] == [
        "xlstm-125m__decode_32k__single.json",
        "xlstm-125m__long_500k__single.json"]
    rec = json.loads(paths[0].read_text())
    assert rec["ok"] and rec["fits"] and rec["mesh"] == "1x1"
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert "1 cached" in capsys.readouterr().out
    roofline.main(["--dryrun", str(tmp_path / "baseline"),
                   "--json", str(tmp_path / "roof.json")])
    out = capsys.readouterr().out
    assert "| xlstm-125m | decode_32k |" in out
    rows = json.loads((tmp_path / "roof.json").read_text())
    assert [r["shape"] for r in rows] == ["decode_32k", "long_500k"]
    assert all(r["dominant"] == "memory" for r in rows)
    assert hlo_stats.HloStats().to_dict()["dot_flops"] == 0.0
