#!/usr/bin/env python3
"""Medians and spreads of the result lines in a log.

    python3 bench/tools/spread.py --sets 6 < runs.log

Reads every result line (a JSON object with ``correct`` and ``metrics``)
from standard input in order, splits them into consecutive sets of
``--sets`` runs, and prints for each set and metric the median, the
spread (the distance between the first and third quartiles of Python's
``statistics.quantiles(values, n=4)`` over the median) and, over all the
sets, the widest spread and five times it: the bound that spread gives."""

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", type=int, default=6)
    args = ap.parse_args()
    rows = []
    for line in sys.stdin:
        line = line.strip()
        if line.startswith("{") and '"correct"' in line:
            rows.append(json.loads(line))
    sets = [rows[i:i + args.sets] for i in range(0, len(rows), args.sets)]
    widest = {}
    for k, s in enumerate(sets):
        names = sorted({m for r in s for m in r["metrics"]})
        print(f"set {k}: {len(s)} runs, correct {[r['correct'] for r in s]}")
        for m in names:
            vals = [r["metrics"][m]["value"] for r in s if m in r["metrics"]]
            med = statistics.median(vals)
            sp = spread(vals) if len(vals) >= 2 and med else float("nan")
            widest[m] = max(widest.get(m, 0.0), sp) if sp == sp else \
                widest.get(m, 0.0)
            print(f"  {m}: median {med!r} spread {sp:.4f} "
                  f"values {[round(v, 4) for v in vals]}")
    for m, sp in sorted(widest.items()):
        print(f"widest {m}: spread {sp:.4f}, five times {5 * sp:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
