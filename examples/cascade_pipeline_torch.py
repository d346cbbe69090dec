"""Cascade prediction-pipeline demo on the PyTorch/CUDA port
(``repro_torch.pipeline``, DESIGN.md §12).

The port's counterpart of ``examples/cascade_pipeline.py``: it serves one
seeded Zipf-skewed trace two ways and prints the story side by side, in
the reference's words:

* **monolithic** — every query goes to the accurate (expensive) model;
* **cascade**    — a preprocess stage feeds a cheap two-model draft
  ensemble; only queries where the drafts *disagree* escalate to the
  accurate model, and the intermediate-result cache answers repeated
  prefixes outright.

The Exp4 selection state lives on ``--device`` (default ``cuda``, which
raises without a card). The frontend runs on a virtual clock, so the output
is the reference's, byte for byte, on either device.

Run:  python examples/cascade_pipeline_torch.py --device cpu
      python examples/cascade_pipeline_torch.py              # on a GPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.frontend import make_clipper
from repro_torch.models.api import resolve_device
from repro_torch.pipeline import pipeline_models, pipeline_scenario, run_pipeline
from repro_torch.workloads import query_trace
from repro_torch.workloads.scenario import D_FEAT


def describe(tag, rep):
    q = rep["queries"]
    cost = sum(pm["service_s"]["sum"] or 0.0
               for pm in rep["per_model"].values())
    print(f"{tag:10s}: attainment={rep['slo']['attainment']:.3f}  "
          f"p50={rep['latency_s']['p50']*1e3:6.2f} ms  "
          f"p99={rep['latency_s']['p99']*1e3:6.2f} ms  "
          f"cost={cost:.3f} replica-s  "
          f"({q['completed']}/{q['submitted']} served)")
    return cost


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="where the selection state lives (cuda or cpu)")
    dev = resolve_device(parser.parse_args(argv).device)

    sc = pipeline_scenario()
    print(f"pipeline regime: {sc.rate:.0f} qps, SLO {sc.slo*1e3:.0f} ms, "
          f"Zipf pool of {sc.pool} unique queries\n")

    models, lat, _, _ = pipeline_models(sc)
    mono = make_clipper({"accurate": models["accurate"]}, "exp4",
                        slo=sc.slo, latency_models={"accurate": lat["accurate"]},
                        seed=sc.seed, device=dev)
    mono.replay(query_trace(sc.arrival_times(), sc.seed, d_feat=D_FEAT,
                            pool=sc.pool))
    mono_cost = describe("monolithic", mono.report())

    rep = run_pipeline(sc, "cascade", device=dev)
    casc_cost = describe("cascade", rep)

    p = rep["pipeline"]
    print(f"\ncascade internals: {p['stage_jobs']} stage jobs for "
          f"{rep['queries']['submitted']} queries; "
          f"{p['escalations']} escalated to the accurate model "
          f"({p['escalation_rate']*100:.1f}%), {p['stages_skipped']} "
          f"answered by the draft tier alone")
    print("intermediate cache hit rate per stage model:")
    for mid, pm in sorted(rep["per_model"].items()):
        c = pm["cache"]
        print(f"  {mid:9s} {c['hit_rate']:.3f}  "
              f"({c['hits']} hits / {c['misses']} misses)")
    split = p["slo_split"]["shares"]
    print("per-stage SLO split (ms): "
          + "  ".join(f"{k}={v*1e3:.2f}" for k, v in split.items()))
    print(f"\ncost: {mono_cost:.3f} -> {casc_cost:.3f} replica-seconds "
          f"({(1 - casc_cost/mono_cost)*100:.0f}% cheaper), tail served by "
          "the model that earns it.")


if __name__ == "__main__":
    main()
