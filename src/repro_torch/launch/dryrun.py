"""Dry run on one H100: every (arch x shape) cell at full width, on the
meta device (port of ``repro.launch.dryrun``, which lowers and compiles
each cell for a 256- or 512-chip TPU mesh).

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
* ``hlo``: ``hlo_stats.HloStats.to_dict()``; ``hlo_text_bytes`` 0 and
  ``default_trip`` 1 (there is no HLO and no loop bound to guess);
* ``trace_s`` in place of ``lower_s`` and ``compile_s``: the wall time of
  building and counting the cell (``renamed`` says so);
* ``chips`` 1, ``capacity_bytes`` and ``fits``: argument + temp bytes
  within the card's memory (``torch.cuda.mem_get_info``'s total where a
  card is visible, else 80 GB).

Two loops are counted at a small size and extrapolated, each on the line
through two counts (``extrapolated`` says from where):

* the ssm family's train and prefill steps run xlstm's sLSTM time loop,
  one Python step per token, with no S^2 term anywhere (chunked scan, time
  loop, FFN): they are counted at 512 and 1024 tokens, 2 and 4 scan chunks
  of 256, where the scan's chunks and the loss's (512) are full;
* a train step whose batch splits into n > 3 microbatches repeats the same
  microbatch n times: it is counted with 2 and 3 microbatches of the same
  size (the reference's HLO count multiplies a loop body by its trip
  count the same way).

Usage::

    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    python -m repro_torch.launch.dryrun          # all 32 cells
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import (
    ModelConfig, ShapeSpec, applicable_shapes, suggest_microbatches,
)
from repro_torch.configs.registry import ARCHITECTURES, get_config, get_shape
from repro_torch.launch import hlo_stats
from repro_torch.launch.hlo_stats import HloStats
from repro_torch.launch.mesh import make_local_mesh
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


def _count(cfg: ModelConfig, shape: ShapeSpec, opts: dict) -> HloStats:
    bundle = build_step(cfg, shape, make_local_mesh(device="meta"), **opts)
    return hlo_stats.count(bundle.fn, *bundle.arg_specs)


def _count_seq(cfg, shape, opts) -> Tuple[HloStats, Optional[dict]]:
    """Counts at the shape's length, or for the ssm family's train and
    prefill steps extrapolated from SSM_LENGTHS."""
    if cfg.family != "ssm" or shape.kind == "decode":
        return _count(cfg, shape, opts), None
    at = SSM_LENGTHS
    a, b = (_count(cfg, dataclasses.replace(shape, seq_len=s), opts)
            for s in at)
    return (hlo_stats.extrapolate(a, b, at[0], at[1], shape.seq_len),
            {"seq_len": list(at)})


def count_cell(cfg: ModelConfig, shape: ShapeSpec, opts: dict
               ) -> Tuple[HloStats, Optional[dict]]:
    """The cell's counts and, where they were extrapolated, from where."""
    nmb = opts.get("num_microbatches") or suggest_microbatches(cfg, shape, 1)
    if shape.kind != "train" or nmb <= 3:
        return _count_seq(cfg, shape, dict(opts, **(
            {"num_microbatches": nmb} if shape.kind == "train" else {})))
    mb = shape.global_batch // nmb
    counts = []
    for k in (2, 3):
        stats, how = _count_seq(
            cfg, dataclasses.replace(shape, global_batch=k * mb),
            dict(opts, num_microbatches=k))
        counts.append(stats)
    how = dict(how or {}, num_microbatches=[2, 3])
    return hlo_stats.extrapolate(counts[0], counts[1], 2, 3, nmb), how


def run_cell(arch: str, shape_name: str, *, step_opts=None,
             verbose: bool = True, capacity: Optional[float] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeSpec] = None) -> dict:
    """One cell's record. ``cfg`` and ``shape`` default to the registry's
    (a test or the card's phase may pass a cut of them)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    opts = dict(step_opts or {})
    capacity = capacity or capacity_bytes()
    rec = {
        "arch": arch, "shape": shape_name, "mesh": "1x1", "devices": 1,
        "chips": 1, "step_opts": opts,
    }
    t0 = time.perf_counter()
    try:
        meta = build_step(cfg, shape, make_local_mesh(device="meta"),
                          **opts).meta
        stats, how = count_cell(cfg, shape, opts)
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
            print(f"OK  {arch} x {shape_name} x 1x1: trace {trace_s:.1f}s | "
                  f"args {args_bytes * gb:.2f}GB temp "
                  f"{mem['peak_bytes'] * gb:.2f}GB fits {rec['fits']} | "
                  f"dotF {stats.dot_flops:.3e}", flush=True)
    except Exception as e:  # noqa: BLE001 — recorded, sweep continues
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc(limit=20),
                    "elapsed_s": round(time.perf_counter() - t0, 2)})
        if verbose:
            print(f"FAIL {arch} x {shape_name} x 1x1: {rec['error']}",
                  flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single"],
                    help="one device (the sharded meshes are not ported)")
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
            path = outdir / f"{arch}__{shape_name}__{args.mesh}.json"
            if path.exists() and not args.force:
                prev = json.loads(path.read_text())
                if prev.get("ok"):
                    n_skip += 1
                    continue
            rec = run_cell(arch, shape_name, step_opts=step_opts,
                           capacity=capacity)
            path.write_text(json.dumps(rec, indent=1))
            n_ok += rec["ok"]
            n_fail += not rec["ok"]
    print(f"\ndone: {n_ok} ok, {n_fail} fail, {n_skip} cached")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
