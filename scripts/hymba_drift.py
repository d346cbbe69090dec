"""Where hymba-1.5b's card-vs-CPU logit gap comes from, layer by layer.

Runs the inputs of ``chip_smoke.py::cpu_parity`` (two prompts of 64 and 37
tokens padded to 64, then 8 teacher-forced decode steps) through seeded
full-width hymba-1.5b four ways, on the same weights:

- ``card``: bf16 on the card, as served (cuBLAS may reduce bf16 partial
  sums in bf16: ``allow_bf16_reduced_precision_reduction`` True, torch's
  default);
- ``card_fp32_red``: the same with that flag False;
- ``cpu``: bf16 on the CPU's plain path, the one ``cpu_parity`` compares
  with;
- ``fp32``: the CPU's plain path in fp32 on the same weights upcast, the
  reference neither bf16 run is rounded like.

It records the residual stream entering each layer and the attention and
SSD branch outputs (the inputs of the block's ``rmsnorm`` calls), the SSD
state of each layer after the prefill, and the logits of every step; then
prints, for each pair of runs, max |a - b| / max |b| per layer. If the
card's distance to ``fp32`` matches the CPU's, both bf16 runs are equally
accurate and their gap is bf16 rounding that the model amplifies, not a
fault of the card.

    python3 scripts/hymba_drift.py [--layers 32] [--out chiprun_out/hymba_drift.json]

Needs a CUDA device; builds the kernels from the checkout."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PAIRS = (("card", "cpu"), ("card_fp32_red", "cpu"), ("card", "card_fp32_red"),
         ("card", "fp32"), ("card_fp32_red", "fp32"), ("cpu", "fp32"))


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _rel(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _order(segs):
    """(cache kind, index in its stack) of each layer in execution order:
    global layer i, then its segment of sliding-window layers."""
    order, lo = [], 0
    for gi, n in enumerate(segs):
        order += [("g", gi)] + [("w", i) for i in range(lo, lo + n)]
        lo += n
    return order


def run(model, params, dev, toks, lens, feeds):
    """Prefill and the decode steps, recording every block ``rmsnorm``
    input (residual, attention output, SSD output per layer, in order);
    returns {"prefill": [3L], "steps": [[3L] per step], "ssd": [L],
    "logits": [9, B, V]}, all fp32 on the CPU."""
    import torch
    from repro_torch.models import hymba

    seen = []
    plain = hymba.rmsnorm

    def recording(x, w, eps):
        seen.append(x.float().cpu())
        return plain(x, w, eps)

    hymba.rmsnorm = recording
    try:
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks).to(dev),
                     "lengths": torch.from_numpy(lens).to(dev)},
            max_len=toks.shape[1] + 16)
        out = {"prefill": seen[:], "steps": [],
               "logits": [logits.float().cpu()]}
        L = len(seen) // 3
        out["ssd"] = [cache["ssd_" + k][i].float().cpu().clone()
                      for k, i in _order(model.extras["segments"])]
        ln = torch.from_numpy(lens).to(dev)
        for t in feeds:
            del seen[:]
            logits, cache = model.decode_step(params, cache,
                                              torch.from_numpy(t).to(dev), ln)
            ln = ln + 1
            out["steps"].append(seen[:])
            out["logits"].append(logits.float().cpu())
        assert len(out["prefill"]) == 3 * L == len(out["steps"][-1])
    finally:
        hymba.rmsnorm = plain
    out["logits"] = torch.stack(out["logits"])
    return out


def compare(runs):
    """Per pair: per-layer relative errors of the residual entering each
    layer, the two branch outputs, the SSD state after the prefill, the
    last decode step's residual, and the logits of each step."""
    res = {}
    for a, b in PAIRS:
        A, B = runs[a], runs[b]
        pre = [_rel(x, y) for x, y in zip(A["prefill"], B["prefill"])]
        last = [_rel(x, y) for x, y in zip(A["steps"][-1], B["steps"][-1])]
        res[f"{a} vs {b}"] = {
            "residual": pre[0::3], "attn_out": pre[1::3],
            "ssd_out": pre[2::3],
            "ssd_state": [_rel(x, y) for x, y in zip(A["ssd"], B["ssd"])],
            "step8_residual": last[0::3],
            "logits": [_rel(x, y) for x, y in zip(A["logits"], B["logits"])],
            "argmax_agree": float((A["logits"].argmax(-1)
                                   == B["logits"].argmax(-1)).float().mean()),
        }
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth cut (the first N layers' globals kept)")
    ap.add_argument("--out", default="chiprun_out/hymba_drift.json")
    args = ap.parse_args()

    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hymba_drift: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    _build.build()
    cfg = ARCHITECTURES["hymba-1.5b"]
    if args.layers != cfg.num_layers:
        cfg = dataclasses.replace(
            cfg, num_layers=args.layers,
            global_layers=tuple(g for g in cfg.global_layers
                                if g < args.layers))
    dev = torch.device("cuda")
    card = build_model(cfg, device=dev)
    params = card.init(torch.Generator(device=dev).manual_seed(0))
    cpu_params = _tree(params, lambda t: t.cpu())
    # the inputs of chip_smoke.py::cpu_parity
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    lens = np.array([64, 37], np.int32)
    feeds = rng.integers(0, cfg.vocab_size, size=(8, 2, 1)).astype(np.int32)

    flag = torch.backends.cuda.matmul
    print(f"allow_bf16_reduced_precision_reduction={flag.allow_bf16_reduced_precision_reduction}"
          f" allow_tf32={flag.allow_tf32}", flush=True)
    runs = {}
    t0 = time.perf_counter()
    runs["card"] = run(card, params, dev, toks, lens, feeds)
    default = flag.allow_bf16_reduced_precision_reduction
    flag.allow_bf16_reduced_precision_reduction = False
    try:
        runs["card_fp32_red"] = run(card, params, dev, toks, lens, feeds)
    finally:
        flag.allow_bf16_reduced_precision_reduction = default
    runs["cpu"] = run(build_model(cfg, device="cpu"), cpu_params, "cpu",
                      toks, lens, feeds)
    runs["fp32"] = run(build_model(cfg, device="cpu", dtype=torch.float32),
                       _tree(cpu_params, lambda t: t.float()), "cpu",
                       toks, lens, feeds)
    print(f"four runs: {time.perf_counter() - t0:.1f} s", flush=True)

    res = compare(runs)
    for pair, r in res.items():
        print(f"{pair}: logits per step {r['logits']}; argmax agreement "
              f"{r['argmax_agree']}")
        for key in ("residual", "attn_out", "ssd_out", "ssd_state",
                    "step8_residual"):
            print(f"  {key}: " + " ".join(f"{e:.4g}" for e in r[key]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": smi, "layers": cfg.num_layers,
                               "global_layers": list(cfg.global_layers),
                               "pairs": res}, indent=1))
    print(json.dumps({pair: {"logits_max": max(r["logits"]),
                             "argmax_agree": r["argmax_agree"]}
                      for pair, r in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
