#!/usr/bin/env python3
"""Offer a cell's traffic at several fixed rates, one process, one set of
weights, and print each rate's end-to-end figures: the sweep that finds
the highest rate the system sustains (the knee), from which an open-loop
cell's rate is set.

    python3 bench/tools/sweep.py --workload hymba-1.5b.docqa1k --seed 11 \\
        --rates 4,8,12,16 --seconds 15

A rate's line gives tokens/s, the tails, the queue left at the window's
end (a queue that grows through the window means the rate is past the
knee) and how late the generator ran. Between rates the queue is dropped
and the running requests finish."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args()

    import torch
    from bench import harness as H
    from bench import traffic as T

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    p = H.prepare(args.workload, args.seed)
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(p.mix, rate=rate)
        seed = args.seed + i
        sched = T.schedule(mix, args.seconds, seed)
        tracked, ws, end, late, s0, s1, _ = H.serve(
            p.server, p.params, mix, sched, seed, args.seconds, p.vocab)
        run = H.Run(ws=ws, end=end, requests=tracked, setup_s=0.0)
        row = {"rate": rate, "sent_in_window": sum(
            1 for tr in tracked if run.in_window(tr.due))}
        for m in ("tokens_per_s", "ttft_p95_ms", "tpot_p95_ms"):
            row[m] = H.reader("e2e", m)(run)
        row["queue_at_end"] = len(p.server._queue)
        row["active_at_end"] = len(p.server._active)
        row["late_p95_ms"] = 1e3 * H._q(sorted(late), 0.95)
        row["prefill_dispatches"] = (s1["prefill_dispatches"]
                                     - s0["prefill_dispatches"])
        row["decode_steps"] = s1["decode_steps"] - s0["decode_steps"]
        print(json.dumps(row), flush=True)
        p.server._queue.clear()
        while p.server.pending:
            p.server.step(p.params)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
