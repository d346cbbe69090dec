"""Prefill flash attention of the checkout given, for comparing two checkouts
on one card in one call: run it for each in turns (A, B, B, A), e.g. the
parent commit unpacked with ``git archive`` into ``build/parent`` against
``.``::

    python3 scripts/flash_checkouts.py CHECKOUT LABEL [--kernel] [--cells]
        [--instances]

``--kernel``: the checkout's ``flash_attention_op`` at the flash rows of
PERF.md's table (the serving rungs, hymba's rung 2048 and exact prompt,
seamless's encoder, cross- and self-attention, internvl2's rungs, dbrx, the
context-parallel ranks, the tensor-parallel ranks, B 1 at 8,192 and 32,768
tokens), three graph-replay reads each (``chip_smoke.graph_ms``: 20 calls
a graph, 5 at 8,192 tokens and past, replayed 5 times).

``--instances``: at the same rows, the checkout's binding (``kernels/
flash_attention/flash_attention.py::flash_attention``) forced to each of
its instances in turns (mma, wgmma, wgmma, mma), one graph-replay read
each, beside the instance ``pick`` chooses; a checkout whose binding has
one instance is skipped.

``--cells``: the prefill_32k launch cell (smollm-360m, 32,768-token
prompts) through the checkout's ``chip_smoke.card_cell``, one timed step
(CUDA events), then one more step under ``torch.profiler``: the device's
busy time a step (the union of its operations' intervals) and flash
attention's kernels' device time a step.

Prints one JSON object a line. Needs a CUDA device; builds the checkout's
kernels into its own ``build/kernels``."""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

# (B, S, Hq, Hkv, D, kv_valid, window, causal, Sk, q_offset)
ROWS = [
    (8, 256, 15, 5, 64, [256, 200, 129, 256, 131, 140, 250, 180], 0, True,
     None, None),
    (8, 2048, 25, 5, 64, [2048, 1600, 1030, 2048, 600, 1280, 2040, 2035],
     2048, True, None, None),
    (1, 3072, 25, 5, 64, None, 2048, True, None, None),
    (8, 1024, 16, 16, 64, None, 0, False, None, None),
    (8, 128, 16, 16, 64, None, 0, False, 1024, None),
    (8, 128, 16, 16, 64, [128, 100, 65, 128, 70, 90, 127, 128], 0, True,
     None, None),
    (8, 256, 14, 2, 64, [256, 200, 129, 256, 131, 140, 250, 180], 0, True,
     None, None),
    (4, 2048, 14, 2, 64, None, 0, True, None, None),
    (8, 256, 48, 8, 128, None, 0, True, None, None),
    *[(2, 512, 15, 5, 64, None, 0, True, 2048, off)
      for off in (0, 512, 1024, 1536)],
    (8, 256, 4, 1, 64, [256, 200, 129, 256, 131, 140, 250, 180], 0, True,
     None, None),
    (4, 256, 8, 1, 64, [256, 200, 129, 31], 0, True, None, None),
    (8, 128, 7, 1, 64, [32, 64, 128, 32, 64, 128, 32, 64], 2048, True, None,
     None),
    (8, 128, 13, 1, 64, [32, 64, 128, 128, 32, 64, 128, 128], 2048, True,
     None, None),
    (8, 1024, 4, 4, 64, None, 0, False, None, None),
    (8, 128, 4, 4, 64, None, 0, False, 1024, None),
    (8, 128, 4, 4, 64, None, 0, True, None, None),
    (1, 8192, 15, 5, 64, None, 0, True, None, None),
    (1, 32768, 15, 5, 64, None, 0, True, None, None),
]


def kernel_times(cs, torch):
    from repro_torch.kernels.flash_attention.ops import flash_attention_op

    dev = torch.device("cuda")
    for B, S, Hq, Hkv, D, lens, window, causal, Sk, q_off in ROWS:
        gen = torch.Generator(device=dev).manual_seed(99)
        Sk = Sk or S
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Sk, Hkv, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)

        def call():
            flash_attention_op(q, k, v, causal=causal, window=window,
                               q_offset=q_off, kv_valid=kv)
        call()
        ms = [cs.graph_ms(call, reps=5 if S >= 8192 else 20)
              for _ in range(3)]
        yield dict(B=B, S=S, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D, causal=causal,
                   window=window, q_offset=q_off, ms=ms, min_ms=min(ms))
        del q, k, v
        torch.cuda.empty_cache()


def instance_times(cs, torch):
    import inspect

    from repro_torch.kernels import softmax_scale
    from repro_torch.kernels.flash_attention import flash_attention as bind

    if "instance" not in inspect.signature(bind.flash_attention).parameters:
        return
    dev = torch.device("cuda")
    for B, S, Hq, Hkv, D, lens, window, causal, Sk, q_off in ROWS:
        gen = torch.Generator(device=dev).manual_seed(99)
        Sk = Sk or S
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Sk, Hkv, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        out = torch.empty_like(q)
        row = dict(B=B, S=S, Sk=Sk, Hq=Hq, Hkv=Hkv, D=D, causal=causal,
                   window=window, q_offset=q_off,
                   pick=bind.geometry(B, S, Sk, Hq, Hkv, D, causal).instance)
        for inst in bind.INSTANCES + bind.INSTANCES[::-1]:
            def call():
                bind.flash_attention(
                    q, k, v, kv, out, causal=causal, window=window,
                    q_offset=Sk - S if q_off is None else q_off, q_block=512,
                    k_block=1024, scale=softmax_scale(None, D),
                    instance=inst)
            row.setdefault(inst, []).append(
                cs.graph_ms(call, reps=5 if S >= 8192 else 20))
        yield row
        del q, k, v, out
        torch.cuda.empty_cache()


def cell_times(cs, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_step

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    c = cs.card_cell(dev, "smollm-360m", "prefill_32k", None, 1,
                     ("rmsnorm", "flash_attention"))
    shape = dataclasses.replace(SHAPES_BY_NAME["prefill_32k"],
                                global_batch=c["batch"])
    bundle = build_step(ARCHITECTURES["smollm-360m"], shape,
                        make_local_mesh())
    args = list(bundle.make_args(0))
    out = bundle.fn(*args)
    torch.cuda.synchronize()
    del out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = bundle.fn(*args)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    flash = [o for o in ops if "flash" in o.name]
    yield dict(
        cell="smollm-360m x prefill_32k", B=c["batch"], step_ms=c["step_ms"],
        launches=c["launches"],
        busy_ms=(cs._union_us([(o.time_range.start, o.time_range.end)
                               for o in ops]) / 1e3 if ops else None),
        flash_ms=sum(o.time_range.end - o.time_range.start
                     for o in flash) / 1e3,
        flash_ops=len(flash), seconds=round(time.perf_counter() - t0, 1))
    del bundle, args, out, prof
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("label")
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--instances", action="store_true")
    a = ap.parse_args()
    root = Path(a.checkout).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_checkouts: needs a CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build()
    for on, fn in ((a.kernel, kernel_times), (a.instances, instance_times),
                   (a.cells, cell_times)):
        if on:
            for row in fn(cs, torch):
                print(json.dumps(dict(checkout=a.label, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
