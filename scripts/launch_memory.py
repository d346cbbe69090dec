"""Where a step's device memory goes beyond what ``hlo_stats`` tracks.

``repro_torch.launch.hlo_stats.count`` tracks the storages that aten ops
return; an op's own scratch memory (a kernel's internal copies and
buffers) is invisible to it. This script measures that scratch on the card:

1. the softmax ops of ``hlo_stats.SCRATCH`` alone, at the
   training forward's score layout (``[B, Hkv, G, S, S]`` fp32, from
   ``common.attention_train``), each with a contiguous and a non-contiguous
   tensor input: the bytes allocated inside the call beyond its output,
   over the bytes of that input;
2. the training step of smollm-360m x train_4k cut to ``--batch``
   sequences of 4,096 under a counting mode that, around every op,
   compares ``torch.cuda.max_memory_allocated`` with the tracker: the ops
   whose scratch is largest, and where the card's peak falls.

    python3 scripts/launch_memory.py [--batch 16] [--out chiprun_out/launch_memory.json]

Needs a CUDA device."""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def scratch(fn, *args):
    """Bytes allocated inside ``fn(*args)`` beyond what stays allocated."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    inner = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    del out
    return inner


def softmax_ops(B=2, Hkv=5, G=3, S=2048):
    import torch
    aten = torch.ops.aten
    shape = (B, Hkv, G, S, S)
    dev = torch.device("cuda")
    dense = torch.randn(shape, device=dev)
    # the einsum's layout: a permuted view of the product's output
    strided = torch.randn((B, Hkv, S, G, S), device=dev).transpose(2, 3)
    nbytes = dense.numel() * 4
    out = torch.softmax(dense, -1)
    rows = []
    for name, fn, args in (
            ("_softmax contiguous", aten._softmax, (dense, -1, False)),
            ("_softmax non-contiguous", aten._softmax, (strided, -1, False)),
            ("_softmax_backward_data contiguous grad",
             aten._softmax_backward_data, (dense, out, -1, torch.float32)),
            ("_softmax_backward_data non-contiguous grad",
             aten._softmax_backward_data, (strided, out, -1, torch.float32)),
            ("_log_softmax non-contiguous", aten._log_softmax,
             (strided, -1, False)),
            ("_log_softmax_backward_data non-contiguous grad",
             aten._log_softmax_backward_data,
             (strided, out, -1, torch.float32))):
        inner = scratch(fn, *args)
        rows.append(dict(op=name, shape=list(shape), input_bytes=nbytes,
                         scratch_bytes=inner, ratio=inner / nbytes))
        print(f"{name}: scratch {inner} B = {inner / nbytes:.4f} x the "
              f"input's {nbytes} B", flush=True)
    return rows


def train_step(batch):
    import torch
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.kernels import recording
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_step

    class Probe(hlo_stats._Counter):
        def __init__(self, *a):
            super().__init__(*a)
            self.rows = []
            self.base = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            torch.cuda.reset_peak_memory_stats()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            now = torch.cuda.memory_allocated() - self.base
            inner = torch.cuda.max_memory_allocated() - self.base - now
            self.rows.append((str(func), inner, now - self.cur, self.cur,
                              now))
            return out

    cfg = ARCHITECTURES["smollm-360m"]
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"],
                                global_batch=batch)
    bundle = build_step(cfg, shape, make_local_mesh())
    args = bundle.make_args(0)
    st = hlo_stats._storages(args)
    probe = Probe(hlo_stats.HloStats(), {k: s.nbytes() for k, s in st.items()})
    torch.cuda.synchronize()
    probe.base = torch.cuda.memory_allocated()
    with probe, recording(probe):
        out = bundle.fn(*args)
    torch.cuda.synchronize()
    top = max(probe.rows, key=lambda r: r[4] + r[1])
    by_op = collections.defaultdict(int)
    for r in probe.rows:
        by_op[r[0]] = max(by_op[r[0]], r[1])
    res = dict(batch=batch, tracked_peak=probe.peak,
               card_peak_op=top[0], card_peak=top[4] + top[1],
               tracked_at_card_peak=top[3], untracked_live_max=max(
                   r[2] for r in probe.rows),
               largest_scratch=sorted(by_op.items(),
                                      key=lambda kv: -kv[1])[:8])
    print(json.dumps(res, indent=1), flush=True)
    del out, args
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default="chiprun_out/launch_memory.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("launch_memory: needs a CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    res = dict(device=torch.cuda.get_device_name(0),
               softmax=softmax_ops(), train=train_step(args.batch))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
