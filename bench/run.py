#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload hymba-1.5b.docqa --seed 7 --seconds 30 --trace 0

From the root of a checkout. Loads the cell's model (``src/repro_torch``)
with weights made from the seed on the card, warms every shape the cell's
traffic can dispatch, serves the traffic for ``--seconds``, and checks a
sample of what it served against the plain float32 reference. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics and ``breakdown``; ``checks`` last); the numbers compared, each
beside its limit, are also the last lines of standard error. Exits 2,
printing no result, without a CUDA card."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from bench import harness

    cell, _, _ = harness.cell_files(harness.manifest(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"bench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_process=T_PROCESS)
    found = harness.banned_modules()
    if found:
        print(f"bench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
