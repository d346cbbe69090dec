"""Quickstart on the PyTorch/CUDA port: serve an LM with Clipper-style
adaptive batching.

The port's counterpart of ``examples/quickstart.py``: stand up the
continuous-batching ``LMServer`` (``repro_torch``) with AIMD admission
control and serve 24 requests of 16 tokens, 24 new tokens each, 8 slots,
temperature 0.8, then print the same telemetry line.

By default it runs on the card and serves full-width smollm-360m (seeded
random weights, bf16), whose fused decode step replays as a CUDA graph
after its first step. ``--device cpu`` serves the reference quickstart's
reduced config (4 layers, d_model 128) on the plain PyTorch path.

Run:  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
      PYTHONPATH=src python examples/quickstart_torch.py       # on a GPU
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.models.api import build_model
from repro_torch.serving.engine import LMServer


def main(argv=None) -> LMServer:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: full width) or cpu (reduced)")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)

    full = ARCHITECTURES["smollm-360m"]
    if dev.type == "cuda":
        cfg, where = full, "full width"
    else:
        cfg = reduced_config(full, num_layers=4, d_model=128)
        where = (f"reduced: {cfg.num_layers}L d={cfg.d_model}, "
                 f"{full.param_count() / 1e6:.0f}M at full size")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    print(f"serving {cfg.name} ({where}) on {dev}")

    server = LMServer(model, device=dev, slots=8, max_len=128,
                      temperature=0.8, seed=0)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    rids = []
    for _ in range(24):
        prompt = rng.integers(0, cfg.vocab_size, size=16)
        rids.append(server.submit(prompt, max_new_tokens=24))
    server.run(params)
    dt = time.perf_counter() - t0

    total_tokens = sum(len(server.completed[r].tokens) for r in rids)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the CPU")
    print(f"completed {len(server.completed)} requests, "
          f"{total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.0f} tok/s on {name})")
    print(f"AIMD admission batch size converged to: "
          f"{server.admission.max_batch_size}")
    r = server.completed[rids[0]]
    print(f"sample generation (request 0): {r.tokens[:12]}...")
    dec = server.engine_report()["decode"]
    print(f"decode: {dec['steps']} steps, {dec['host_syncs_per_step']} host "
          f"syncs per step, CUDA graph: {dec['graph']}")

    # shared telemetry schema (core/metrics.py): the fields the reference
    # quickstart prints
    rep = server.report()
    lat, bs = rep["latency_s"], rep["batch_size"]
    print(f"telemetry: p50={lat['p50']*1e3:.0f}ms p99={lat['p99']*1e3:.0f}ms "
          f"throughput={rep['throughput_qps']:.1f} req/s "
          f"slo_violation_rate={rep['slo']['rate']:.2f} "
          f"mean_batch={bs['mean']:.1f}")
    return server


if __name__ == "__main__":
    main()
