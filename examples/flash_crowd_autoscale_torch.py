"""Flash-crowd autoscaling demo on the PyTorch/CUDA port (control plane,
DESIGN.md §10).

The port's counterpart of ``examples/flash_crowd_autoscale.py``: it replays
the same seeded flash-crowd trace twice through the Clipper frontend — once
with replica counts frozen at the steady-state provisioning (one replica),
once with the reactive autoscaler watching the telemetry — and prints the
SLO story side by side, plus the replica excursion the controller took.

The stack's selection state lives on ``--device`` (default ``cuda``, which
raises without a card). The loop runs on a virtual clock, so the output is
the reference's, byte for byte, on either device.

Run:  python examples/flash_crowd_autoscale_torch.py --device cpu
      python examples/flash_crowd_autoscale_torch.py              # on a GPU
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
from repro_torch.cluster import ClusterPlan, cluster_scenario, run_plan
from repro_torch.models.api import resolve_device


def describe(tag, rep):
    q = rep["queries"]
    print(f"{tag:10s}: attainment={rep['slo']['attainment']:.3f}  "
          f"violations={rep['slo']['violations']:4d}/{q['submitted']}  "
          f"p50={rep['latency_s']['p50']*1e3:7.1f} ms  "
          f"p99={rep['latency_s']['p99']*1e3:7.1f} ms")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="where the selection state lives (cuda or cpu)")
    dev = resolve_device(parser.parse_args(argv).device)

    sc = cluster_scenario("flash_crowd")
    print(f"flash crowd: {sc.rate:.0f} qps baseline, {sc.peak_rate:.0f} qps "
          f"spike, SLO {sc.slo*1e3:.0f} ms, 1 steady-state replica\n")

    fixed = run_plan(ClusterPlan(scenario=sc, autoscale=False, device=dev))
    describe("fixed", fixed)

    auto = run_plan(ClusterPlan(scenario=sc, autoscale=True, device=dev))
    describe("autoscaled", auto)

    a = auto["cluster"]["autoscalers"][0]
    print(f"\nreplicas: 1 -> {a['peak_live']} (spike) -> {a['live']} (final);"
          f" {a['added']} added, {a['retired']} drained + retired")
    print("scale events:")
    for ev in a["events"]:
        print(f"  t={ev['t']:5.2f}s  {ev['action']:4s} -> {ev['live']} live "
              f"(target {ev['want']})")
    print("\nSame trace, same seed, same containers — the only difference is "
          "the control loop\nwatching queue depth, arrival rate, and service "
          "times each 50 ms tick (InferLine-style).")


if __name__ == "__main__":
    main()
