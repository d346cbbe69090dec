"""Dry run of every (arch x shape) cell at full width on the meta device,
on one H100 and on one rank of each production mesh (port of
``repro.launch.dryrun``, which lowers and compiles each cell for a 256- or
512-chip TPU mesh).

``--mesh`` names the meshes, as the reference's does:

* ``one``: one device, the whole step (records ``{arch}__{shape}__one
  .json``, ``"mesh": "1x1"``, ``devices`` and ``chips`` 1);
* ``single``: one rank of (data 16, model 16) (``__single.json``,
  ``"16x16"``, 256); ``multi``: one rank of (pod 2, data 16, model 16)
  (``__multi.json``, ``"pod2x16x16"``, 512); ``both`` (the default): the
  two of them.

A production mesh is counted on one counting rank (``launch.mesh.
make_rank_mesh``): the rank's own blocks of the weights, its rows of the
batch, its cache, and its collectives recorded by their bytes rather than
run. The reference compiles one SPMD program for every device, so the
port counts the rank at the origin, or, under ``context_parallel``, the
last rank along ``model``, whose rows attend the most keys; the record
names it (``rank_coords``).

Each cell's step (``launch.steps.build_step``) runs on meta tensors under
``hlo_stats.count``: shapes only, no memory, no kernel. The record keeps
the reference's keys, filled from the counts:

* ``memory_analysis``: ``argument_bytes`` (the arguments' storages),
  ``output_bytes`` (outputs in storages the step allocated),
  ``alias_bytes`` (outputs in the arguments' storages: decode's cache,
  updated in place), ``temp_bytes`` (the peak of live bytes beyond the
  arguments) and ``code_bytes`` 0;
* ``cost_analysis``: ``flops_body_once`` is every counted operation (dots
  and kernels; a Python loop counts every trip, nothing is counted once);
  ``bytes_accessed_body_once`` is None (eager ops' traffic is not counted);
* ``hlo``: ``hlo_stats.HloStats.to_dict()``, on a rank with the
  collectives' wire bytes by op and by axes; ``hlo_text_bytes`` 0 and
  ``default_trip`` 1 (there is no HLO and no loop bound to guess);
* ``trace_s`` in place of ``lower_s`` and ``compile_s``: the wall time of
  building and counting the cell (``renamed`` says so);
* ``chips``, ``capacity_bytes`` and ``fits``: one rank's argument + temp
  bytes within one card's memory (``torch.cuda.mem_get_info``'s total
  where a card is visible, else 80 GB).

A train step takes the microbatch count ``build_train_step`` takes on the
mesh, ``suggest_microbatches`` over its data shards (data x pod). Two loops
are counted at a small size and extrapolated, each on the line through two
counts (``extrapolated`` says from where), collectives included:

* the ssm family's train and prefill steps run xlstm's sLSTM time loop,
  one Python step per token, with no S^2 term anywhere (chunked scan, time
  loop, FFN): they are counted at 512 and 1024 tokens, 2 and 4 scan chunks
  of 256, where the scan's chunks and the loss's (512) are full;
* a train step whose batch splits into n > 3 microbatches repeats the same
  microbatch n times: it is counted with 2 and 3 microbatches of the same
  size (the reference's HLO count multiplies a loop body by its trip
  count the same way).

Usage::

    python -m repro_torch.launch.dryrun --mesh one --arch smollm-360m --shape train_4k
    python -m repro_torch.launch.dryrun --mesh one     # all 32 cells, one device
    python -m repro_torch.launch.dryrun                # 64: a rank of each mesh
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (
    ModelConfig, ShapeSpec, applicable_shapes, suggest_microbatches,
)
from repro_torch.configs.registry import ARCHITECTURES, get_config, get_shape
from repro_torch.launch import hlo_stats
from repro_torch.launch.hlo_stats import HloStats
from repro_torch.launch.mesh import (
    PRODUCTION, Mesh, make_local_mesh, make_rank_mesh,
)
from repro_torch.launch.steps import build_step

DEFAULT_CAPACITY = 80e9      # one H100's device memory, bytes
# the ssm family's two counted lengths: 2 and 4 of xlstm's scan chunks
# (models/xlstm.py::build), each a multiple of the loss chunk
# (models/common.py::chunked_loss)
SSM_LENGTHS = (512, 1024)


def capacity_bytes() -> float:
    if torch.cuda.is_available():
        return float(torch.cuda.mem_get_info()[1])
    return DEFAULT_CAPACITY


# --mesh's names -> the record's name of the mesh
MESH_NAMES = {"one": "1x1", "single": "16x16", "multi": "pod2x16x16"}
MESH_CHOICES = {"one": ("one",), "single": ("single",), "multi": ("multi",),
                "both": ("single", "multi")}


def cell_mesh(mesh: str = "one", opts: Optional[dict] = None) -> Mesh:
    """The mesh a cell is counted on: one device on meta (``"one"``), or
    the counting rank of a production mesh (``"single"``, ``"multi"``) at
    the origin, or under ``context_parallel`` the last rank along
    ``model``."""
    if mesh == "one":
        return make_local_mesh(device="meta")
    shape = PRODUCTION[mesh]
    coords = dict.fromkeys(shape, 0)
    if (opts or {}).get("context_parallel"):
        coords["model"] = shape["model"] - 1
    return make_rank_mesh(tuple(shape.values()), tuple(shape), coords)


def _count(cfg: ModelConfig, shape: ShapeSpec, opts: dict,
           mesh: Optional[Mesh] = None) -> HloStats:
    mesh = mesh or cell_mesh()
    bundle = build_step(cfg, shape, mesh, **opts)
    return hlo_stats.count(bundle.fn, *bundle.arg_specs, mesh=mesh)


def _count_seq(cfg, shape, opts, mesh) -> Tuple[HloStats, Optional[dict]]:
    """Counts at the shape's length, or for the ssm family's train and
    prefill steps extrapolated from SSM_LENGTHS."""
    if cfg.family != "ssm" or shape.kind == "decode":
        return _count(cfg, shape, opts, mesh), None
    at = SSM_LENGTHS
    a, b = (_count(cfg, dataclasses.replace(shape, seq_len=s), opts, mesh)
            for s in at)
    return (hlo_stats.extrapolate(a, b, at[0], at[1], shape.seq_len),
            {"seq_len": list(at)})


def count_cell(cfg: ModelConfig, shape: ShapeSpec, opts: dict,
               mesh: Optional[Mesh] = None
               ) -> Tuple[HloStats, Optional[dict]]:
    """The cell's counts on ``mesh`` (one device by default) and, where
    they were extrapolated, from where."""
    mesh = mesh or cell_mesh()
    dp = mesh.size(("pod", "data")) if mesh.world is not None else 1
    nmb = opts.get("num_microbatches") or suggest_microbatches(cfg, shape,
                                                               dp)
    if shape.kind != "train" or nmb <= 3:
        return _count_seq(cfg, shape, dict(opts, **(
            {"num_microbatches": nmb} if shape.kind == "train" else {})),
            mesh)
    mb = shape.global_batch // nmb
    counts = []
    for k in (2, 3):
        stats, how = _count_seq(
            cfg, dataclasses.replace(shape, global_batch=k * mb),
            dict(opts, num_microbatches=k), mesh)
        counts.append(stats)
    how = dict(how or {}, num_microbatches=[2, 3])
    return hlo_stats.extrapolate(counts[0], counts[1], 2, 3, nmb), how


def run_cell(arch: str, shape_name: str, *, mesh: str = "one",
             step_opts=None, verbose: bool = True,
             capacity: Optional[float] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeSpec] = None) -> dict:
    """One cell's record on ``mesh`` (``"one"``, ``"single"`` or
    ``"multi"``). ``cfg`` and ``shape`` default to the registry's (a test
    or the card's phase may pass a cut of them)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    opts = dict(step_opts or {})
    capacity = capacity or capacity_bytes()
    where = cell_mesh(mesh, opts)
    n = int(np.prod(list(where.shape.values())))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": MESH_NAMES[mesh],
        "devices": n, "chips": n, "step_opts": opts,
    }
    if where.world is not None:
        rec["rank_coords"] = dict(where.world.coords)
    t0 = time.perf_counter()
    try:
        meta = build_step(cfg, shape, where, **opts).meta
        stats, how = count_cell(cfg, shape, opts, where)
        trace_s = time.perf_counter() - t0
        mem = stats.memory
        args_bytes = mem["argument_bytes"]
        hs = stats.to_dict()
        total = sum(hs["dot_flops_by_dtype"].values()) + sum(
            n for w in hs["kernel_work"].values()
            for n in w["flops"].values())
        rec.update({
            "ok": True,
            "trace_s": round(trace_s, 2),
            "renamed": {"lower_s": "trace_s", "compile_s": "trace_s"},
            "meta": meta,
            "memory_analysis": {
                "argument_bytes": int(args_bytes),
                "output_bytes": int(mem["output_bytes"]),
                "temp_bytes": int(mem["peak_bytes"]),
                "alias_bytes": int(mem["alias_bytes"]),
                "code_bytes": 0,
            },
            "cost_analysis": {
                "flops_body_once": float(total),
                "bytes_accessed_body_once": None,
            },
            "hlo": hs,
            "hlo_text_bytes": 0,
            "default_trip": 1,
            "extrapolated": how,
            "capacity_bytes": capacity,
            "fits": bool(args_bytes + mem["peak_bytes"] <= capacity),
        })
        if verbose:
            gb = 1e-9
            print(f"OK  {arch} x {shape_name} x {rec['mesh']}: trace "
                  f"{trace_s:.1f}s | args {args_bytes * gb:.2f}GB temp "
                  f"{mem['peak_bytes'] * gb:.2f}GB fits {rec['fits']} | "
                  f"coll {stats.total_collective_bytes * gb:.3f}GB | "
                  f"dotF {stats.dot_flops:.3e}", flush=True)
    except Exception as e:  # noqa: BLE001 — recorded, sweep continues
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(limit=20),
                    "elapsed_s": round(time.perf_counter() - t0, 2)})
        if verbose:
            print(f"FAIL {arch} x {shape_name} x {rec['mesh']}: "
                  f"{rec['error']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=list(MESH_CHOICES),
                    help="one device, a rank of 16 x 16 (single), of 2 x 16 "
                         "x 16 (multi), or a rank of both")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have results")
    ap.add_argument("--tag", default="baseline",
                    help="variant tag for §Perf iterations")
    ap.add_argument("--opts", default="{}",
                    help="JSON step opts (e.g. remat, q_block, optimizer)")
    args = ap.parse_args(argv)

    outdir = Path(args.out) / args.tag
    outdir.mkdir(parents=True, exist_ok=True)
    step_opts = json.loads(args.opts)
    capacity = capacity_bytes()

    archs = sorted(ARCHITECTURES) if args.arch == "all" else args.arch.split(",")
    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([s.name for s in applicable_shapes(cfg)]
                  if args.shape == "all" else args.shape.split(","))
        for shape_name in shapes:
            for mesh in MESH_CHOICES[args.mesh]:
                path = outdir / f"{arch}__{shape_name}__{mesh}.json"
                if path.exists() and not args.force:
                    prev = json.loads(path.read_text())
                    if prev.get("ok"):
                        n_skip += 1
                        continue
                rec = run_cell(arch, shape_name, mesh=mesh,
                               step_opts=step_opts, capacity=capacity)
                path.write_text(json.dumps(rec, indent=1))
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"\ndone: {n_ok} ok, {n_fail} fail, {n_skip} cached")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
