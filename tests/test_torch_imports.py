"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither ``jax`` nor the ``repro`` package, no
source line of them or of ``examples/*_torch.py`` imports them or the
reference's ``benchmarks`` folder,
and ``chip_smoke.py`` refuses to run without a card or outside the
repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_GUARD = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
missing = sorted(set(MUST) - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""
# modules the guard must find (and import without loading JAX): the
# frontend stack, the obs layer, the scenario CLI, the hybrid family, the
# pipelines, the control plane, faults, the exporter and the validator,
# the encoder-decoder and moe families, the serving launcher, the
# training slice (data, optimizers, loop, checkpoints, launcher) and the
# launch and sharding tooling among them
MUST = ("repro_torch.core.frontend", "repro_torch.core.selection",
        "repro_torch.core.context", "repro_torch.core.straggler",
        "repro_torch.core.cache", "repro_torch.core.containers",
        "repro_torch.obs", "repro_torch.obs.tracer", "repro_torch.obs.cli",
        "repro_torch.workloads.scenario", "repro_torch.workloads.run",
        "repro_torch.models.hymba", "repro_torch.pipeline.cascade",
        "repro_torch.pipeline.scenario", "repro_torch.cluster.plan",
        "repro_torch.faults.plan", "repro_torch.obs.export",
        "repro_torch.metrics.validate", "repro_torch.models.encdec",
        "repro_torch.models.moe", "repro_torch.launch.serve",
        "repro_torch.tree", "repro_torch.data.pipeline",
        "repro_torch.training.optimizer", "repro_torch.training.grad_compress",
        "repro_torch.training.train_loop",
        "repro_torch.checkpoint.checkpointer", "repro_torch.launch.train",
        "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
        "repro_torch.launch.inputs", "repro_torch.launch.steps",
        "repro_torch.launch.hlo_stats", "repro_torch.launch.dryrun",
        "repro_torch.launch.roofline")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c",
         f"MUST = {MUST!r}\n" + _GUARD.format(root=str(ROOT))],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_line_imports_jax_or_repro():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {p.name for p in examples} >= {
        "quickstart_torch.py", "train_lm_torch.py", "common_torch.py",
        "cascade_pipeline_torch.py", "flash_crowd_autoscale_torch.py",
        "adaptive_batching_demo_torch.py", "ensemble_serving_torch.py"}
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "repro",
                                               "benchmarks"), (
                    f"{path}: imports {m}")


def test_chip_smoke_refuses_without_a_card():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
