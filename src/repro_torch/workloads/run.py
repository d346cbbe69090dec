"""CLI, counterpart of ``repro.workloads.run``: replay a named workload
scenario through a serving stack and print the structured report.

    PYTHONPATH=src python -m repro_torch.workloads.run --scenario poisson --stack frontend
    PYTHONPATH=src python -m repro_torch.workloads.run --scenario stragglers --seed 7
    PYTHONPATH=src python -m repro_torch.workloads.run --scenario poisson --stack lmserver --device cpu

The flags are the reference's, plus ``--device`` (default ``cuda``: the
run needs a card unless given ``--device cpu``).

The report is the shared ``repro.metrics/v1`` schema (DESIGN.md §9):
P50/P95/P99 latency, throughput, SLO-violation rate, cache hit rate,
batch-size and queue-depth distributions, per-model breakdowns, plus the
scenario parameters that produced it. Output is deterministic: the same
seed yields byte-identical JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.obs.cli import add_fleet_args, build_fleet, write_fleet
from repro_torch.workloads.scenario import SCENARIOS, ScenarioRunner


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads.run",
        description="Replay a workload scenario and emit a telemetry report.")
    p.add_argument("--scenario", default="poisson", choices=sorted(SCENARIOS),
                   help="named load profile (see DESIGN.md §9)")
    p.add_argument("--stack", default="frontend",
                   choices=("frontend", "lmserver"),
                   help="serving stack to drive")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the selection state and the LM live "
                        "(default cuda: raises without a card)")
    p.add_argument("--seed", type=int, default=None,
                   help="override the scenario seed")
    p.add_argument("--duration", type=float, default=None,
                   help="override the trace duration (s)")
    p.add_argument("--rate", type=float, default=None,
                   help="override the mean arrival rate (qps)")
    p.add_argument("--replicas", type=int, default=None,
                   help="override replicas per model (frontend stack)")
    p.add_argument("--report-out", "--out", dest="out", default=None,
                   help="write the JSON report here instead of stdout "
                        "(--out kept as an alias; --report-out is the flag "
                        "shared with python -m repro.cluster.run)")
    p.add_argument("--trace-out", default=None,
                   help="record per-query spans (repro.obs) and write the "
                        "repro.trace/v1 span log here — byte-identical per "
                        "seed; convert with python -m repro.obs.export")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="head-based trace sampling rate in [0, 1] "
                        "(default 1.0; only meaningful with --trace-out)")
    add_fleet_args(p)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    overrides = {k: v for k, v in (("seed", args.seed),
                                   ("duration", args.duration),
                                   ("rate", args.rate),
                                   ("replicas", args.replicas))
                 if v is not None}
    # validate before running: the trace generators assert on these, and a
    # bare AssertionError is a bad CLI surface
    sc = dataclasses.replace(SCENARIOS[args.scenario], **overrides)
    if sc.duration <= 0:
        parser.error("--duration must be > 0")
    if sc.rate <= 0:
        parser.error("--rate must be > 0")
    if sc.kind != "poisson" and sc.rate > sc.peak_rate:
        parser.error(f"--rate {sc.rate:g} exceeds the {sc.name!r} scenario's "
                     f"peak rate {sc.peak_rate:g}")
    if sc.replicas < 1:
        parser.error("--replicas must be >= 1")
    tracer = None
    if args.trace_out:
        if not 0.0 <= args.trace_sample_rate <= 1.0:
            parser.error("--trace-sample-rate must be in [0, 1]")
        from repro_torch.obs import Tracer
        # the reference's document, byte for byte: no engine step spans
        tracer = Tracer(sample_rate=args.trace_sample_rate, seed=sc.seed,
                        engine=False)
    sampler, audit = build_fleet(args, parser)
    text = ScenarioRunner(sc, tracer=tracer, sampler=sampler, audit=audit,
                          device=args.device).run_json(args.stack)
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(tracer.to_json() + "\n")
    write_fleet(args, sampler, audit)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
