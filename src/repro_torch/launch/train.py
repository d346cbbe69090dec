"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Port of ``python -m repro.launch.train``, with its flags and defaults.
``--device`` (default ``cuda``; raises without a card, ``cpu`` runs the
same code on the CPU) picks the device. Checkpoint/restart: re-launching
with the same ``--ckpt`` resumes.

Under ``python -m torch.distributed.run --nproc-per-node N -m
repro_torch.launch.train ...`` each process is one rank on its own card
and trains on the elastic mesh over the world with the reference's
training rules (each rank its rows of every batch; moe experts split over
``model``); each rank checkpoints its own shards. Rank 0 prints. Without
a world, one device, as before."""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.pipeline import data_iter
from repro_torch.distributed.sharding import train_rules
from repro_torch.launch.mesh import init_world_from_env, make_elastic_mesh
from repro_torch.models.api import build_model, resolve_device
from repro_torch.training.train_loop import TrainConfig, train


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="width/depth-reduced config (CPU-friendly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, num_layers=6, d_model=256, vocab_size=4096)
        cfg = dataclasses.replace(cfg, d_ff=0 if cfg.d_ff == 0 else 1024)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    dev = resolve_device(args.device)
    mesh, say = None, print
    if init_world_from_env(dev):
        mesh = make_elastic_mesh(device=dev)
        dev = mesh.world.device
        if mesh.world.rank:
            say = lambda *a: None                         # noqa: E731
    model = build_model(cfg, device=dev, mesh=mesh,
                        rules=train_rules(False) if mesh else None)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                     total_steps=args.steps,
                     num_microbatches=args.microbatches,
                     optimizer=args.optimizer)
    say(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) on "
        f"{dev}" + (f", mesh {mesh.shape}" if mesh else "")
        + f" for {args.steps} steps")
    out = train(model, tc, data_iter(cfg, shape, seed=args.seed),
                num_steps=args.steps, checkpoint_dir=args.ckpt, log_every=10,
                hooks={"on_log": lambda m: say(
                    f"  step {m['step']:5d}  loss {m['loss']:.4f}  "
                    f"lr {m['lr']:.2e}")})
    h = out["history"]
    say(f"done: loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
