#!/usr/bin/env python3
"""Check the engine's step spans on the card, in one cell, one process.

    python3 bench/tools/step_spans.py --workload dbrx-132b.batch --seed 11 \\
        --seconds 51 --cost-seconds 15

1. Serves the cell's traffic as a traced run does (the program's tracer,
   the harness's labels, the profiler over the window's last
   ``trace_seconds``) and prints: the tracer's summary (``dropped`` must
   read 0) and each ring's drops; the admissions' ``limit`` values in the
   window; per step-span name, the spans inside the profiled span against
   the profiler's host ranges of that name, and how many of those lie
   inside a ``bench.admit`` / ``bench.decode`` label; the device events
   of those names the trace's reduction counts as device work (must be
   none); ``busy_s``; and every per-layer metric of the cell.
2. Times the instrumentation alone: the tracer calls of one admission and
   of one decode step, as ``LMServer`` makes them, without a profiler.
3. Serves ``--cost-seconds`` more with the step spans on and off in turn,
   call by call, and prints each kind of call's host time both ways."""

import argparse
import json
import statistics
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

NAMES = ("engine.admit", "engine.prefill.issue", "engine.prefill.wait",
         "engine.place", "engine.decode", "engine.decode.launch",
         "engine.decode.wait")


def ranges(prof):
    """(host ranges of NAMES, device events of NAMES the reduction keeps,
    device annotations of NAMES it drops), each (name, start_us, end_us)."""
    from torch.autograd import DeviceType
    from bench import trace as TR
    host, annotations = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.name() not in NAMES:
            continue
        if e.device_type() == DeviceType.CPU:
            host.append((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3))
        else:
            annotations += 1
    dev, _ = TR._events(prof)
    kept = [d for d in dev if d[0] in NAMES]
    return host, kept, annotations


def labelled(host_all, rngs):
    """How many of ``rngs`` lie inside a harness label."""
    labels = [(s, e) for n, s, e in host_all if n in ("bench.admit",
                                                      "bench.decode")]
    return sum(any(s <= a and b <= e for s, e in labels)
               for _, a, b in rngs)


def span_calls_us(n: int = 20000):
    """Microseconds of the tracer calls of one admission and of one decode
    step (clock reads included), on a tracer of its own."""
    from repro_torch.obs.tracer import Tracer
    clock = time.perf_counter
    tr = Tracer()
    attrs = {"prompts": 1, "rows": 1, "rung": 1024, "padded": True,
             "tokens_valid": 700, "tokens_padded": 1024, "free": 1,
             "queued": 40, "budget": 16, "limit": "slots"}
    t0 = clock()
    for _ in range(n):
        step = tr.start_step("engine.admit", "engine", clock(),
                             attrs=dict(attrs))
        phase = tr.start_span(step, "engine.prefill.issue", "engine",
                              clock())
        t = clock()
        tr.end_span(phase, t)
        phase = tr.start_span(step, "engine.prefill.wait", "engine", t)
        tr.end_span(phase, clock())
        phase = tr.start_span(step, "engine.place", "engine", clock())
        t = clock()
        tr.end_span(phase, t)
        tr.end_span(step, t)
    admit = (clock() - t0) / n
    t0 = clock()
    for _ in range(n):
        step = tr.start_step("engine.decode", "engine", clock(),
                             attrs={"active": 16, "mode": "replay"})
        phase = tr.start_span(step, "engine.decode.launch", "engine",
                              clock())
        t = clock()
        tr.end_span(phase, t)
        phase = tr.start_span(step, "engine.decode.wait", "engine", t)
        tr.end_span(phase, clock())
        tr.end_span(step, clock())
    decode = (clock() - t0) / n
    return 1e6 * admit, 1e6 * decode


def toggled_cost(p, seconds: float, seed: int):
    """Serve ``seconds`` more with the step spans on for every other call
    of each kind; host microseconds of the calls that did work, both ways."""
    from bench import harness as H
    from bench import traffic as T
    srv, tracer = p.server, p.tracer
    times = {(k, on): [] for k in ("admit", "decode") for on in (0, 1)}
    turn = {"admit": 0, "decode": 0}
    admit, decode = srv._admit, srv._decode_once

    def wrap(kind, fn, worked):
        def call(params):
            on = turn[kind] = 1 - turn[kind]
            srv._steps = tracer if on else None
            before = worked()
            t0 = time.perf_counter()
            fn(params)
            dt = time.perf_counter() - t0
            if worked() != before:
                times[(kind, on)].append(1e6 * dt)
        return call

    srv._admit = wrap("admit", admit, lambda: srv.prefill_dispatches)
    srv._decode_once = wrap("decode", decode, lambda: srv.decode_steps)
    sched = T.schedule(p.mix, seconds, seed)
    H.serve(srv, p.params, p.mix, sched, seed, seconds, p.vocab)
    srv._admit, srv._decode_once = admit, decode
    srv._steps = tracer
    out = {}
    for (kind, on), v in sorted(times.items()):
        if len(v) >= 4:
            q = statistics.quantiles(v, n=4)
            out[f"{kind}_{'on' if on else 'off'}_us"] = {
                "n": len(v), "median": statistics.median(v),
                "mean": statistics.fmean(v), "q1": q[0], "q3": q[2]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost-seconds", type=float, default=15.0)
    args = ap.parse_args()

    import torch
    from bench import harness as H
    from bench import trace as TR
    from bench import traffic as T

    if not torch.cuda.is_available():
        print("step_spans: no CUDA card", file=sys.stderr)
        return 2
    p = H.prepare(args.workload, args.seed, trace=True)
    run_log = {"on": False, "traced": False, "admits": [], "decodes": []}
    H._wrap(p.server, run_log, time.perf_counter)
    H._profiler_ready(p.dev)
    sched = T.schedule(p.mix, args.seconds, args.seed)
    tracked, ws, end, late, s0, s1, prof = H.serve(
        p.server, p.params, p.mix, sched, args.seed, args.seconds, p.vocab,
        trace_seconds=float(p.mix.get("trace_seconds", 2.0)),
        run_log=run_log)
    lo, hi = prof[1]
    spans = p.tracer.spans()
    run = H.Run(cfg=p.conf, family=p.family, mix=p.mix, setup_s=0.0, ws=ws,
                end=end, requests=tracked, stats0=s0, stats1=s1,
                lateness=late, admits=run_log["admits"],
                decodes=run_log["decodes"], spans=spans,
                trace=TR.reduce(prof[0], lo, hi), profiled=(lo, hi))
    host, kept, annotations = ranges(prof[0])
    host_all = TR._events(prof[0])[1]
    inside = Counter(s.name for s in spans if s.name in NAMES
                     and lo <= s.start and s.end <= hi)
    out = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "tracer": p.tracer.summary(),
        "dropped_requests_steps": [p.tracer.log.dropped,
                                   p.tracer.step_log.dropped],
        "limits": dict(Counter(
            s.attrs["limit"] for s in spans if s.name == "engine.admit"
            and run.in_window(s.start))),
        "step_spans_in_window": dict(Counter(
            s.name for s in spans if s.name in NAMES and run.in_window(
                s.start))),
        "spans_inside_profiled": dict(inside),
        "ranges": dict(Counter(n for n, _, _ in host)),
        "ranges_inside_labels": labelled(host_all, host),
        "device_events_kept": len(kept),
        "device_annotations_dropped": annotations,
        "busy_s": run.trace["busy_s"], "window_s": run.trace["window_s"],
        "metrics": H.read_metrics(run, p.man["per_layer"], "metrics",
                                  args.workload),
    }
    print(json.dumps(out), flush=True)
    admit_us, decode_us = span_calls_us()
    print(json.dumps({"span_calls_us": {"admit": admit_us,
                                        "decode": decode_us}}), flush=True)
    if args.cost_seconds > 0:
        print(json.dumps({"toggled": toggled_cost(
            p, args.cost_seconds, args.seed + 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
