"""CLI, counterpart of ``repro.pipeline.run``: serve a workload trace
through a prediction pipeline and print the structured report.

    PYTHONPATH=src python -m repro_torch.pipeline.run --scenario cascade
    PYTHONPATH=src python -m repro_torch.pipeline.run --scenario fanout \
        --seed 7
    PYTHONPATH=src python -m repro_torch.pipeline.run --scenario lmcascade \
        --device cpu --report-out report.json

The flags are the reference's, plus ``--device`` (default ``cuda``: the
run needs a card unless given ``--device cpu``).

``--scenario`` picks the pipeline shape (DESIGN.md §12): ``cascade`` and
``fanout`` run DAGs of model containers on the Clipper frontend;
``lmcascade`` runs draft-then-verify across two LM engines. ``--profile``
picks the workload trace (a named scenario from DESIGN.md §9; default the
``pipeline`` regime). Reports use the shared ``repro.metrics/v1`` schema
plus a ``pipeline`` / ``cascade`` section, and are byte-identical per seed.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.cli import add_fleet_args, build_fleet, write_fleet
from repro_torch.pipeline.scenario import (CASCADE_THRESHOLD,
                                           pipeline_scenario, run_lmcascade,
                                           run_pipeline)
from repro_torch.workloads.scenario import SCENARIOS

PIPELINES = ("cascade", "fanout", "lmcascade")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.pipeline.run",
        description="Serve a workload trace through a prediction pipeline "
                    "(DAG composition / cascade) and emit a telemetry "
                    "report.")
    p.add_argument("--scenario", default="cascade", choices=PIPELINES,
                   help="pipeline shape (see DESIGN.md §12)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the selection state and the LM live "
                        "(default cuda: raises without a card)")
    p.add_argument("--profile", default="pipeline", choices=sorted(SCENARIOS),
                   help="named workload profile supplying the arrival trace")
    p.add_argument("--seed", type=int, default=None,
                   help="override the profile seed")
    p.add_argument("--duration", type=float, default=None,
                   help="override the trace duration (s)")
    p.add_argument("--rate", type=float, default=None,
                   help="override the mean arrival rate (qps)")
    p.add_argument("--pool", type=int, default=None,
                   help="unique-query pool size (0 = all unique)")
    p.add_argument("--threshold", type=float, default=None,
                   help="cascade escalation threshold (frontend cascade: "
                        f"draft agreement, default {CASCADE_THRESHOLD}; "
                        "lmcascade: distinct-token confidence, default 0.9)")
    p.add_argument("--no-cache", dest="use_cache", action="store_false",
                   help="disable the intermediate-result cache "
                        "(cascade/fanout only)")
    p.add_argument("--report-out", default=None,
                   help="write the JSON report here instead of stdout")
    p.add_argument("--trace-out", default=None,
                   help="record per-query spans (repro_torch.obs) and write "
                        "the repro.trace/v1 span log here — byte-identical "
                        "per seed; convert with python -m "
                        "repro_torch.obs.export")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="head-based trace sampling rate in [0, 1] "
                        "(default 1.0; only meaningful with --trace-out)")
    add_fleet_args(p)
    return p


def main(argv=None) -> int:
    import json

    parser = build_parser()
    args = parser.parse_args(argv)
    overrides = {k: v for k, v in (("seed", args.seed),
                                   ("duration", args.duration),
                                   ("rate", args.rate),
                                   ("pool", args.pool))
                 if v is not None}
    sc = pipeline_scenario(args.profile, **overrides)
    if sc.duration <= 0:
        parser.error("--duration must be > 0")
    if sc.rate <= 0:
        parser.error("--rate must be > 0")
    if sc.kind != "poisson" and sc.rate > sc.peak_rate:
        parser.error(f"--rate {sc.rate:g} exceeds the {sc.name!r} profile's "
                     f"peak rate {sc.peak_rate:g}")
    if sc.pool < 0:
        parser.error("--pool must be >= 0")
    tracer = None
    if args.trace_out:
        if not 0.0 <= args.trace_sample_rate <= 1.0:
            parser.error("--trace-sample-rate must be in [0, 1]")
        from repro_torch.obs import Tracer
        # the reference's document, byte for byte: no engine step spans
        tracer = Tracer(sample_rate=args.trace_sample_rate, seed=sc.seed,
                        engine=False)
    sampler, audit = build_fleet(args, parser)
    if args.scenario == "lmcascade":
        if not args.use_cache:
            parser.error("--no-cache applies to the frontend pipelines "
                         "only (lmcascade has no intermediate-result cache)")
        thr = 0.9 if args.threshold is None else args.threshold
        rep = run_lmcascade(sc, threshold=thr, tracer=tracer,
                            sampler=sampler, audit=audit, device=args.device)
    else:
        thr = CASCADE_THRESHOLD if args.threshold is None else args.threshold
        rep = run_pipeline(sc, args.scenario, threshold=thr,
                           use_cache=args.use_cache, tracer=tracer,
                           sampler=sampler, audit=audit, device=args.device)
    text = json.dumps(rep, sort_keys=True, indent=2)
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(tracer.to_json() + "\n")
    write_fleet(args, sampler, audit)
    if args.report_out:
        with open(args.report_out, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
