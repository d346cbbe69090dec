"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Port of ``python -m repro.launch.serve``: stands up the continuous-batching
``LMServer`` (AIMD admission, slot decode) for one architecture with seeded
random weights and drives it with a synthetic request stream. ``--device``
(default ``cuda``; raises without a card, ``cpu`` runs the plain path)
picks the device and a seeded ``torch.Generator`` takes the place of the
reference's PRNG key.

Under ``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.serve ...`` each process is one rank on its own card,
and the server runs on the elastic mesh over the world (``(1, N)`` up to
16 ranks, ``(N / 16, 16)`` past that), as the reference's launcher serves
on ``make_elastic_mesh``: attention, FFN, embedding and head (and the
moe experts) split over ``model``, the slots over ``data`` (``--slots``
rounded up to a multiple of it). Rank 0 prints. Without a world, one
device, as before.

As in the reference, requests carry tokens only: an encoder-decoder
(seamless-m4t-medium) has no frames to prefill and fails with
``KeyError: 'frames'``."""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.distributed.sharding import serve_rules
from repro_torch.launch.mesh import init_world_from_env, make_elastic_mesh
from repro_torch.models.api import build_model, resolve_device
from repro_torch.serving.engine import LMServer


def main(argv: Optional[List[str]] = None) -> LMServer:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, num_layers=4, d_model=128)
    dev = resolve_device(args.device)
    mesh, say = None, print
    if init_world_from_env(dev):
        mesh = make_elastic_mesh(device=dev)
        dev = mesh.world.device
        if mesh.world.rank:
            say = lambda *a: None                         # noqa: E731
    model = build_model(cfg, device=dev, mesh=mesh,
                        rules=serve_rules(False) if mesh else None)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rows = mesh.shape["data"] if mesh else 1
    server = LMServer(model, device=dev, slots=-(-args.slots // rows) * rows,
                      max_len=args.max_len, temperature=args.temperature)
    rng = np.random.default_rng(0)
    say(f"serving {cfg.name} on {dev}"
        + (f", mesh {mesh.shape}" if mesh else "")
        + f"; {args.requests} requests x {args.max_new} tokens")
    t0 = time.perf_counter()
    rids = [server.submit(rng.integers(0, cfg.vocab_size, args.prompt_len),
                          max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    server.run(params)
    dt = time.perf_counter() - t0
    toks = sum(len(server.completed[r].tokens) for r in rids)
    say(f"completed {len(server.completed)}/{args.requests} requests, "
        f"{toks} tokens in {dt:.2f}s ({toks / dt:.0f} tok/s); "
        f"AIMD admission batch = {server.admission.max_batch_size}")
    return server


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
