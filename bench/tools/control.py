#!/usr/bin/env python3
"""The readings the check's limit is set from, in one process.

For each seed: weights from the seed, the cell's traffic served for a
short window, the finished requests sampled as a benchmark run samples
them (``bench/check.py``), and the widest gap of the served tokens below
the float32 reference's best (the program's reading). For the first
``--control`` seeds also the control's reading: the reference with every
product's inputs rounded to float8, the gap of the token it puts first at
each position of the same prompts and served tokens.

    python3 bench/tools/control.py --workload hymba-1.5b.docqa1k \\
        --seeds 101,102,103 --seconds 10 --control 3

One JSON line a seed; the limit lies above the program's largest reading
and below the control's smallest."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args()

    import torch
    from bench import check
    from bench import harness as H
    from bench import traffic as T

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    model = None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        p = H.prepare(args.workload, seed, model=model)
        model = p.model
        sched = T.schedule(p.mix, args.seconds, seed)
        tracked, *_ = H.serve(p.server, p.params, p.mix, sched, seed,
                              args.seconds, p.vocab)
        done = H.finished(p, tracked)
        H.release(p)
        pick = check.sample(done, p.mix, seed, p.conf.get("window")
                            if p.family == "hybrid" else None)
        t1 = time.perf_counter()
        row = {"seed": seed, "requests": len(pick)}
        if i < args.control:
            row.update(check.control_gap(p.family, p.conf, p.params, pick,
                                         p.dev))
        else:
            r = check.control_gap(p.family, p.conf, p.params, pick, p.dev,
                                  control=False)
            row.update(r)
        row["serve_s"] = t1 - t0
        row["check_s"] = time.perf_counter() - t1
        print(json.dumps(row), flush=True)
        del p
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
