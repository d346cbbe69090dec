"""Decode attention of the checkout given, for comparing two checkouts on one
card in one call: run it for each in turns (A, B, B, A), e.g. the parent
commit unpacked with ``git archive`` into ``build/parent`` against ``.``::

    python3 scripts/decode_checkouts.py CHECKOUT LABEL [--kernel] [--cells]

``--kernel``: the kernel through the checkout's C entry point
(``kernels/decode_attention/decode_attention.py::decode_attention`` at a
given split) at the workspace split's shapes: hymba's long_500k global
cache (B 1, 25 / 5 heads, Smax 524,288) at P = 32, 64, 128, 256, smollm's
decode_32k (B 32, the lengths of ``chip_smoke.LONG_CASES``) at P = 16, 32,
and B 1 at 65,536 / B 2 at 131,072 positions; then, at the split the
checkout chooses, decode_32k and the serving shapes of PERF.md's table
(smollm at Smax 256, hymba's 2048-slot ring and 3200-slot cache, seamless's
self-attention (lengths 1-128 of 1024) and cross-attention over 1024 rows,
internvl2's prefixed cache of 2112, dbrx's 128-wide heads at 512); three
graph-replay reads each (``chip_smoke.graph_ms``: 20 calls a graph,
replayed 5 times). A checkout whose binding takes no split (before the
workspace split) runs only the rows at its own choice.

``--cells``: the two decode launch cells (hymba-1.5b x long_500k, smollm-360m
x decode_32k at 32 slots) through the checkout's ``chip_smoke.card_cell``,
16 eager steps (CUDA events), then 4 more steps under ``torch.profiler``:
the device's busy time a step (the union of its operations' intervals) and
decode attention's kernels' device time a step.

Prints one JSON object a line. Needs a CUDA device; builds the checkout's
kernels into its own ``build/kernels``."""

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path


def kernel_times(cs, torch):
    import inspect

    from repro_torch.kernels import softmax_scale
    from repro_torch.kernels.decode_attention import decode_attention as bind

    takes_p = "p" in inspect.signature(bind.decode_attention).parameters
    dev = torch.device("cuda")
    long32k = cs.LONG_CASES["decode_attention"][0][-1]
    for B, Hq, Hkv, D, Smax, lengths, ps in (
            (1, 25, 5, 64, 524288, [524288], (32, 64, 128, 256)),
            (32, 15, 5, 64, 32768, long32k, (16, 32)),
            (1, 25, 5, 64, 65536, [65536], (53,)),
            (2, 25, 5, 64, 131072, [131072, 77777], (27,)),
            (32, 15, 5, 64, 32768, long32k, (None,)),
            (8, 15, 5, 64, 256, [0, 1, 37, 128, 200, 255, 256, 64], (None,)),
            (8, 25, 5, 64, 2048, [1, 300, 2048, 2048, 1500, 2048, 37, 2048],
             (None,)),
            (8, 25, 5, 64, 3200, [1, 400, 3200, 3200, 2500, 3100, 37, 3200],
             (None,)),
            (8, 16, 16, 64, 1024, [9, 40, 128, 1, 77, 100, 64, 30], (None,)),
            (8, 16, 16, 64, 1024, [1024] * 8, (None,)),
            (8, 14, 2, 64, 2112, [2049, 2080, 2112, 2100, 1, 1, 1, 1],
             (None,)),
            (8, 48, 8, 128, 512, [33, 64, 200, 287, 0, 512, 129, 260],
             (None,))):
        if not takes_p and ps != (None,):
            continue
        gen = torch.Generator(device=dev).manual_seed(99)
        q = torch.randn((B, Hq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Smax, Hkv, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        for p in ps:
            def call():
                bind.decode_attention(q, k, v, ln, out, window=0,
                                      scale=softmax_scale(None, D),
                                      **({"p": p} if p else {}))
            call()
            ms = [cs.graph_ms(call, reps=5) for _ in range(3)]
            yield dict(B=B, Hq=Hq, Hkv=Hkv, D=D, Smax=Smax, p=p or "chosen",
                       ms=ms, min_ms=min(ms))
        del k, v
        torch.cuda.empty_cache()


def cell_times(cs, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_step

    dev = torch.device("cuda")
    for arch, shape_name, batch in (("hymba-1.5b", "long_500k", None),
                                    ("smollm-360m", "decode_32k", 32)):
        t0 = time.perf_counter()
        c = cs.card_cell(dev, arch, shape_name, batch, 16,
                         ("rmsnorm", "decode_attention"))
        shape = dataclasses.replace(SHAPES_BY_NAME[shape_name],
                                    global_batch=c["batch"])
        bundle = build_step(ARCHITECTURES[arch], shape, make_local_mesh())
        args = list(bundle.make_args(0))
        out = bundle.fn(*args)
        torch.cuda.synchronize()
        n = 4
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                out = bundle.fn(*args)
                args[2] = out[0].argmax(-1, keepdim=True).to(torch.int32)
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dec = [o for o in ops if "decode_" in o.name]
        yield dict(
            cell=f"{arch} x {shape_name}", B=c["batch"],
            step_ms=c["step_ms"], ms=[round(x, 3) for x in c["ms"]],
            launches=c["launches"],
            busy_ms=(cs._union_us([(o.time_range.start, o.time_range.end)
                                   for o in ops]) / 1e3 / n
                     if ops else None),
            decode_ms=sum(o.time_range.end - o.time_range.start
                          for o in dec) / 1e3 / n,
            decode_ops=len(dec) / n,
            seconds=round(time.perf_counter() - t0, 1))
        del bundle, args, out, prof
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("label")
    ap.add_argument("--kernel", action="store_true")
    ap.add_argument("--cells", action="store_true")
    a = ap.parse_args()
    root = Path(a.checkout).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_checkouts: needs a CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build()
    for on, fn in ((a.kernel, kernel_times), (a.cells, cell_times)):
        if on:
            for row in fn(cs, torch):
                print(json.dumps(dict(checkout=a.label, **row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
