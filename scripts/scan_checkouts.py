"""The ssd_scan kernel of the checkout given, for comparing two checkouts on
one card in one call: run it for each in turns (A, B, B, A), e.g. the parent
commit unpacked with ``git archive`` into ``build/parent`` against ``.``::

    python3 scripts/scan_checkouts.py CHECKOUT LABEL [--kernel] [--cells]
        [--instances]

``--kernel``: the checkout's ``ssd_scan_op`` at every ssd_scan row of
PERF.md's table (``chip_smoke.py::scan_cases`` (a)-(i): the mLSTM's five
shapes, hymba's rung 2048 from a carried state and its exact 3,072 prompt,
the tensor-parallel ranks' rung 128 at 7 and 13 heads), on the same inputs
as ``scan_cases`` draws them, three graph-replay reads each
(``chip_smoke.graph_ms``: 20 calls a graph, replayed 5 times).

``--instances``: at the same rows, the checkout's binding forced to each of
its instances in turns (serial, chunked, chunked, serial), one graph-replay
read each, beside the instance ``pick`` chooses; a checkout whose binding
has one instance is skipped, and so is an instance at a shape it does not
take (the chunked one where dk > 32).

``--cells``: full-width hymba-1.5b (32 layers, seeded random weights): a
B 8 ladder-padded prefill at rung 2048 (lengths 2048 and 1366 in turns, as
``chip_smoke.prefill_rungs`` pads) and one exact 3,072-token prompt. For
each, the wall time of a prefill (host clock around a synchronised call,
median of 3), then one more under ``torch.profiler``: the device's busy
time (the union of its operations' intervals) and ssd_scan's kernels'
device time and count.

Prints one JSON object a line. Needs a CUDA device; builds the checkout's
kernels into its own ``build/kernels``."""

import argparse
import json
import sys
import time
from pathlib import Path

# (tag, B, S, H, dk, dv, initial state) as chip_smoke.py::scan_cases
ROWS = [("a", 8, 256, 4, 384, 384, "zero"),
        ("b", 8, 256, 4, 384, 1, "zero"),
        ("c", 8, 512, 4, 384, 384, "random"),
        ("d", 1, 8, 4, 384, 384, "zero"),
        ("e", 8, 256, 4, 384, 385, "zero"),
        ("f", 8, 2048, 25, 16, 64, "random"),
        ("g", 1, 3072, 25, 16, 64, "zero"),
        ("h", 8, 128, 7, 16, 64, "zero"),
        ("i", 8, 128, 13, 16, 64, "zero")]
LENS = {8: [8], 256: [256, 200, 129, 256, 131, 140, 250, 180],
        512: [512, 300, 257, 480, 90, 512, 400, 333],
        2048: [2048, 1600, 1030, 2048, 600, 1280, 2040, 2035],
        3072: [3072], 128: [32, 64, 128, 32, 64, 128, 32, 64]}
CHUNK = 256


def _inputs(torch, dev, tag, B, S, H, hd, dv, state):
    """The inputs ``chip_smoke.py::scan_cases`` draws for a row."""
    import torch.nn.functional as F
    from repro_torch.models.linear_core import pad_mask_gates

    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    raw = randn((2, B, S, H))
    vl = torch.tensor(LENS[S][:B], dtype=torch.int32, device=dev)
    if H == 4:
        q = randn((B, S, H, hd), hd ** -0.5).to(torch.bfloat16)
        k = randn((B, S, H, hd), hd ** -0.5).to(torch.bfloat16)
        lf, li = F.logsigmoid(raw[0] + 4.0), F.logsigmoid(raw[1])
    else:
        q = randn((B, S, H, hd)).to(torch.bfloat16)
        k = randn((B, S, H, hd)).to(torch.bfloat16)
        dt = F.softplus(raw[0]).clamp(1e-4, 8.0)
        lf, li = -dt, torch.log(dt)
    v = randn((B, S, H, dv)).to(torch.bfloat16)
    if dv == hd + 1:
        v[..., -1] = 1
    if tag != "g":
        lf, li = pad_mask_gates(lf, li, vl)
    s0 = (torch.zeros((B, H, hd, dv), device=dev) if state == "zero"
          else randn((B, H, hd, dv)))
    return q, k, v, lf, li, s0


def kernel_times(cs, torch):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op

    dev = torch.device("cuda")
    for tag, B, S, H, hd, dv, state in ROWS:
        q, k, v, lf, li, s0 = _inputs(torch, dev, tag, B, S, H, hd, dv,
                                      state)

        def call():
            ssd_scan_op(q, k, v, lf, li, chunk=CHUNK, initial_state=s0)
        ms = [cs.graph_ms(call) for _ in range(3)]
        yield dict(row=tag, B=B, S=S, H=H, dk=hd, dv=dv, ms=ms,
                   min_ms=min(ms))


def instance_times(cs, torch):
    import inspect

    from repro_torch.kernels.ssd_scan import ssd_scan as bind

    if "instance" not in inspect.signature(bind.ssd_scan).parameters:
        return
    dev = torch.device("cuda")
    for tag, B, S, H, hd, dv, state in ROWS:
        q, k, v, lf, li, s0 = _inputs(torch, dev, tag, B, S, H, hd, dv,
                                      state)
        y = torch.empty_like(v)
        st = torch.empty((B, H, hd, dv), device=dev)
        W = min(CHUNK, S)
        row = dict(row=tag, B=B, S=S, H=H, dk=hd, dv=dv,
                   pick=bind.geometry(B, H, hd, dv, W, S // W).instance)
        insts = []
        for inst in bind.INSTANCES:
            try:
                bind.geometry(B, H, hd, dv, W, S // W, inst)
                insts.append(inst)
            except ValueError:     # a shape the instance does not take
                pass
        for inst in insts + insts[::-1]:
            def call(inst=inst):
                bind.ssd_scan(q, k, v, lf, li, s0, y, st, chunk=W,
                              instance=inst)
            row.setdefault(inst, []).append(cs.graph_ms(call))
        yield row


def cell_times(cs, torch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models.api import build_model

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = ARCHITECTURES["hymba-1.5b"]
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(2)
    lens = torch.full((8,), 2048, dtype=torch.int32, device=dev)
    lens[1::2] = 2048 - 2048 // 3
    for name, batch in (
            ("hymba-1.5b rung 2048 prefill (B 8, padded)",
             {"tokens": torch.randint(0, cfg.vocab_size, (8, 2048),
                                      generator=gen, device=dev,
                                      dtype=torch.int32),
              "lengths": lens}),
            ("hymba-1.5b exact 3072-token prompt (B 1)",
             {"tokens": torch.randint(0, cfg.vocab_size, (1, 3072),
                                      generator=gen, device=dev,
                                      dtype=torch.int32)})):
        with torch.no_grad():
            model.prefill(params, batch, max_len=3200)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                model.prefill(params, batch, max_len=3200)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t1))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model.prefill(params, batch, max_len=3200)
                torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        scan = [o for o in ops if "ssd_" in o.name]
        yield dict(
            cell=name, wall_ms=sorted(walls)[1], walls_ms=walls,
            busy_ms=(cs._union_us([(o.time_range.start, o.time_range.end)
                                   for o in ops]) / 1e3 if ops else None),
            ssd_scan_ms=sum(o.time_range.end - o.time_range.start
                            for o in scan) / 1e3,
            ssd_scan_kernels=len(scan), device_ops=len(ops),
            seconds=round(time.perf_counter() - t0, 1))
    del model, params
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
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scan_checkouts: needs a CUDA device")
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
