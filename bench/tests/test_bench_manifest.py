"""BENCHMARK.json against the contract's shape, and every name in it
against the files the harness finds it by."""

import ast
import importlib.util
import json
import re

import pytest

import _tiny

ROOT = _tiny.ROOT
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) for p in MAN["paths"])
    assert len(json.dumps(MAN)) < 64 * 1024
    # the command names no repo file outside the paths
    for w in MAN["command"]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])


def test_names_units_and_sources():
    names = [c["name"] for c in MAN["configs"]] + list(CELLS) + \
        [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        cap = 0.25
        assert 0.01 <= m["bound"] <= cap
    assert "setup_s" in E2E


def test_every_per_layer_cell_reports_what_it_moves():
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E
        assert _line(m["layer"])
        moved = E2E[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], \
                (m["name"], cell)


def test_every_cell_reports_enough():
    for cell in CELLS.values():
        assert cell["chips"] in (1, 4) and _line(cell["why"])
        assert cell["config"] in {c["name"] for c in MAN["configs"]}
        e2e = [m for m in MAN["end_to_end"]
               if cell["name"] in m.get("workloads", CELLS)]
        assert len(e2e) >= 2 and any(m["name"] == "setup_s" for m in e2e)
        assert any(cell["name"] in m.get("workloads", CELLS)
                   for m in MAN["per_layer"])
    pairs = [(c["config"], c["traffic"]) for c in CELLS.values()]
    assert len(set(pairs)) == len(pairs)


def test_configs_files_and_reduced():
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not (k.endswith("_dim") or k.endswith("_rank")
                        or k in ("d_model", "d_ff", "num_experts_per_tok",
                                 "ssm_state", "head_dim"))
        assert _line(c["why"]) and _line(c["source"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files_exist(cell):
    w = CELLS[cell]
    mix = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json")
                     .read_text())
    assert mix["mode"] in ("open", "closed")
    assert {"slots", "max_len", "slo_s"} <= set(mix["server"])
    assert {"min_tokens", "max_requests", "min_compared",
            "gap_limit"} <= set(mix["check"])
    assert cell == f"{w['config']}.{w['traffic']}"


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_declares_its_entry(m):
    path = ROOT / "bench" / "metrics" / f"{m['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"])
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%" and mod.KERNELS


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_reader_exists(m):
    src = (ROOT / "bench" / "e2e" / f"{m['name']}.py").read_text()
    assert "def read(run)" in src
    ast.parse(src)
