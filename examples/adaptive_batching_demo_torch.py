"""Adaptive batching demo on the PyTorch/CUDA port (paper §4.3, Figs 3-4
live).

The port's counterpart of ``examples/adaptive_batching_demo.py``: it times
real batches of three predictors of the Fig 3 spectrum on ``--device``
(default ``cuda``, which raises without a card), then shows AIMD
discovering each one's maximum SLO-compliant batch size online — no manual
tuning (the paper's core §4.3 claim). Same SLO, controller and steps as the
reference; it prints the reference's lines.

Run:  python examples/adaptive_batching_demo_torch.py --device cpu
      python examples/adaptive_batching_demo_torch.py              # on a GPU
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from common_torch import D_FEAT, make_containers, time_batch
from repro_torch.core import AIMDController, MetricsRegistry
from repro_torch.core import metrics as M
from repro_torch.models.api import resolve_device


def main(argv=None):
    """Returns each model's AIMD path: ``{name: [(batch, seconds), ...]}``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="where the predictors run (cuda or cpu)")
    dev = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    fns = make_containers(rng, dev)
    slo = 0.020
    metrics = MetricsRegistry(slo)
    paths = {}
    for name in ("linear_svm", "kernel_svm", "big_mlp"):
        fn = fns[name]
        ctrl = AIMDController(slo, additive=4, backoff=0.9)
        history = []
        for step in range(60):
            b = ctrl.max_batch_size
            x = rng.normal(size=(b, D_FEAT)).astype(np.float32)
            lat = time_batch(fn, x, iters=1, device=dev)
            ctrl.record(b, lat)
            metrics.observe(M.BATCH_SIZE, b, model=name)
            metrics.observe(M.SERVICE, lat, model=name)
            history.append((b, lat))
        bs = [h[0] for h in history]
        svc = metrics.hist(M.SERVICE, model=name)
        print(f"{name:12s}: AIMD converged max batch = {ctrl.max_batch_size:5d} "
              f"(path: {bs[0]} -> {bs[10]} -> {bs[30]} -> {bs[-1]}), "
              f"latency at converged batch = {history[-1][1]*1e3:.1f} ms "
              f"(SLO {slo*1e3:.0f} ms), "
              f"service p95 = {svc.percentile(95)*1e3:.1f} ms")
        paths[name] = history
    print("\nNo per-model tuning: the same controller found each container's "
          "throughput-optimal batch under the latency objective (Fig 4).")
    return paths


if __name__ == "__main__":
    main()
