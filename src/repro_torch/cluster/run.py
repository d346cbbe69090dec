"""CLI, counterpart of ``repro.cluster.run``: replay a workload scenario
with the control plane active and print the structured report.

    PYTHONPATH=src python -m repro_torch.cluster.run --scenario flash_crowd
    PYTHONPATH=src python -m repro_torch.cluster.run --scenario flash_crowd \
        --no-autoscale --admission shed --report-out report.json
    PYTHONPATH=src python -m repro_torch.cluster.run --scenario diurnal \
        --seed 7 --device cpu

The report is the shared ``repro.metrics/v1`` schema plus a ``cluster``
section: the plan, per-model replica timelines, scale events, and
per-replica accounting. Output is deterministic: the same plan yields
byte-identical JSON (DESIGN.md §10). The flags are the reference's, plus
``--device`` (default ``cuda``: the run needs a card unless given
``--device cpu``).
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.cluster.admission import POLICIES
from repro_torch.cluster.plan import (ClusterPlan, cluster_scenario,
                                      run_plan_json)
from repro_torch.cluster.router import ROUTERS
from repro_torch.faults import parse_fault
from repro_torch.obs.cli import add_fleet_args, build_fleet, write_fleet
from repro_torch.workloads.scenario import SCENARIOS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.run",
        description="Replay a workload scenario with the SLO-aware control "
                    "plane (autoscaling, admission control, heterogeneous "
                    "routing) and emit a telemetry report.")
    p.add_argument("--scenario", default="flash_crowd",
                   choices=sorted(SCENARIOS),
                   help="named load profile (re-parameterized for the "
                        "control-plane regime; see DESIGN.md §10)")
    p.add_argument("--stack", default="frontend",
                   choices=("frontend", "lmserver", "pipeline"),
                   help="serving stack to drive (autoscaling: frontend and "
                        "pipeline; the pipeline stack provisions each stage "
                        "independently)")
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
                   help="initial replicas per model")
    p.add_argument("--no-autoscale", dest="autoscale", action="store_false",
                   help="freeze replica counts (fixed-capacity baseline)")
    p.add_argument("--admission", default=None, choices=POLICIES,
                   help="SLO-aware admission policy (default: off)")
    p.add_argument("--router", default="lect", choices=sorted(ROUTERS),
                   help="replica routing strategy")
    p.add_argument("--tick", type=float, default=0.05,
                   help="control period in virtual seconds")
    p.add_argument("--max-replicas", type=int, default=8,
                   help="autoscaler ceiling per model")
    p.add_argument("--fault", action="append", default=[], metavar="SPEC",
                   help="inject a fault (repeatable; DESIGN.md §14): "
                        "crash:<model>:<replica>@<at>[:<recover_at>], "
                        "flaky:<model>:<replica>:<p>, or "
                        "slow:<model>:<replica>:<factor>[@<from>:<until>]")
    p.add_argument("--no-recovery", dest="recovery", action="store_false",
                   help="disable failure detection + hedged retries (the "
                        "collapse baseline; only meaningful with --fault)")
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
    parser = build_parser()
    args = parser.parse_args(argv)
    overrides = {k: v for k, v in (("seed", args.seed),
                                   ("duration", args.duration),
                                   ("rate", args.rate),
                                   ("replicas", args.replicas))
                 if v is not None}
    if args.stack == "pipeline":
        # the pipeline stack brings its own model zoo + cost shape
        # (repro_torch.pipeline.scenario); the single-model CLUSTER_DEFAULTS
        # would distort it, so use the named scenario as-is
        import dataclasses

        from repro_torch.workloads.scenario import SCENARIOS as _S
        sc = dataclasses.replace(_S[args.scenario], **overrides)
    else:
        sc = cluster_scenario(args.scenario, **overrides)
    if sc.duration <= 0:
        parser.error("--duration must be > 0")
    if sc.rate <= 0:
        parser.error("--rate must be > 0")
    if sc.kind != "poisson" and sc.rate > sc.peak_rate:
        parser.error(f"--rate {sc.rate:g} exceeds the {sc.name!r} scenario's "
                     f"peak rate {sc.peak_rate:g}")
    if sc.replicas < 1:
        parser.error("--replicas must be >= 1")
    if args.tick <= 0:
        parser.error("--tick must be > 0")
    for spec in args.fault:
        try:
            parse_fault(spec)
        except ValueError as e:
            parser.error(str(e))
    if args.fault and args.stack == "lmserver":
        parser.error("--fault applies to the frontend/pipeline stacks")
    plan = ClusterPlan(scenario=sc, stack=args.stack,
                       autoscale=args.autoscale, admission=args.admission,
                       router=args.router, tick=args.tick,
                       max_replicas=args.max_replicas,
                       faults=tuple(args.fault), recovery=args.recovery,
                       device=args.device)
    tracer = None
    if args.trace_out:
        if not 0.0 <= args.trace_sample_rate <= 1.0:
            parser.error("--trace-sample-rate must be in [0, 1]")
        from repro_torch.obs import Tracer
        # the reference's document, byte for byte: no engine step spans
        tracer = Tracer(sample_rate=args.trace_sample_rate, seed=sc.seed,
                        engine=False)
    sampler, audit = build_fleet(args, parser)
    text = run_plan_json(plan, tracer=tracer, sampler=sampler, audit=audit)
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
