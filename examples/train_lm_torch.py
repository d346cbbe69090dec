"""Train a small LM for a few hundred steps with the port's training
substrate: the deterministic data pipeline, AdamW with a cosine schedule,
microbatch gradient accumulation, NaN-step skipping and checkpoint/restart
(kill it mid-run and re-launch: it resumes). The PyTorch twin of
``examples/train_lm.py``, with its flags plus ``--device``.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--full]
      [--device cpu]

By default a width-reduced smollm variant (~8M params) trains; --full trains
the true smollm-360m config (meant for the card). ``--device`` defaults to
``cuda`` and raises without a card.
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.pipeline import data_iter
from repro_torch.models.api import build_model, resolve_device
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced_config(cfg, num_layers=6, d_model=256, vocab_size=4096)
        cfg = dataclasses.replace(cfg, d_ff=0 if cfg.d_ff == 0 else 1024)
    shape = ShapeSpec("train_small", 256, 16, "train")
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, batch {shape.global_batch}x{shape.seq_len} "
          f"on {dev}")
    tc = TrainConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps,
                     num_microbatches=4)
    out = train(model, tc, data_iter(cfg, shape), num_steps=args.steps,
                checkpoint_dir=args.ckpt, checkpoint_every=50, log_every=20,
                hooks={"on_log": lambda m: print(
                    f"  step {m['step']:4d}  loss {m['loss']:.4f}  "
                    f"gnorm {m['gnorm']:.2f}  lr {m['lr']:.2e}")})
    h = out["history"]
    print(f"loss: {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f} "
          f"(checkpoints in {args.ckpt}; rerun to resume)")
    return out


if __name__ == "__main__":
    main()
