"""Ensemble serving with online model selection on the PyTorch/CUDA port
(paper §5 end to end).

The port's counterpart of ``examples/ensemble_serving.py``: it trains five
linear models of graded quality on ``--device`` (default ``cuda``, which
raises without a card), deploys them behind the Clipper frontend with the
Exp4 ensemble policy (its state on the same device), streams queries with
feedback, injects a model failure mid-stream, and shows the selection layer
routing around it (Fig 8 live). It prints the reference's lines.

Run:  python examples/ensemble_serving_torch.py --device cpu
      python examples/ensemble_serving_torch.py              # on a GPU
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from common_torch import make_task, np_call, train_linear_model
from repro_torch.core import Feedback, linear_latency, make_clipper
from repro_torch.core.selection import exp4_weights
from repro_torch.models.api import resolve_device


def main(argv=None):
    """Returns each phase's error rate and Exp4 weights, and the five
    trained predictors (tensor in, tensor out on the device)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="where the models and Exp4 run (cuda or cpu)")
    dev = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    W, label = make_task(rng)
    print("training 5 base models (graded label noise)...")
    models, predictors, state = {}, [], {"broken": False}
    for i, nz in enumerate([0.5, 0.4, 0.3, 0.2, 0.1]):
        predictors.append(train_linear_model(rng, W, noise=nz, device=dev))
        fn = np_call(predictors[-1], dev)
        if i == 4:                                    # best model, will fail
            base = fn
            fn = (lambda x: rng.normal(size=(len(x), W.shape[1]))
                  if state["broken"] else base(x))
        models[f"m{i}"] = fn

    clip = make_clipper(
        models, "exp4", slo=0.020,
        latency_models={m: linear_latency(0.001, 2e-5) for m in models},
        device=dev)

    t, phases = 0.0, []

    def serve(n, tag):
        nonlocal t
        errs = []
        for _ in range(n):
            x = rng.normal(size=(W.shape[0],)).astype(np.float32)
            clip.run(until=t)
            qid = clip.submit(x, arrival_time=t)
            t += 0.002
            clip.run()
            pred = clip.results[qid]
            y = int(label(x[None])[0])
            errs.append(int(np.argmax(pred.y) != y))
            clip.feedback(Feedback(qid, x, y))
        w = exp4_weights(clip.policy_state).cpu().numpy()
        print(f"  [{tag}] err={np.mean(errs):.3f}  "
              f"weights={np.array2string(w, precision=2)}")
        phases.append((np.mean(errs), w))

    print("phase 1: all models healthy")
    serve(400, "healthy")
    print("phase 2: best model (m4) fails — watch Exp4 reroute")
    state["broken"] = True
    serve(400, "failed ")
    print("phase 3: m4 recovers")
    state["broken"] = False
    serve(400, "healed ")
    print("done — the ensemble absorbed a model failure with no operator "
          "action (paper Fig 8).")

    rep = clip.report()
    print(f"telemetry: served={rep['queries']['completed']} "
          f"p99={rep['latency_s']['p99']*1e3:.1f}ms "
          f"slo_violations={rep['slo']['violations']} "
          f"cache_hit_rate={rep['cache']['hit_rate']:.2f} "
          f"stragglers={rep['stragglers']['partial_queries']}")
    return dict(errors=[e for e, _ in phases], weights=[w for _, w in phases],
                predictors=predictors)


if __name__ == "__main__":
    main()
