"""The earlier flash attention kernel (one ``mma.sync`` design, the source of
the checkout given, e.g. the parent commit unpacked with ``git archive``
into ``build/parent``) with one part taken out at a time, to see which part
its time goes to::

    python3 scripts/flash_ablation.py CHECKOUT

Builds, under ``build/ablate``, the checkout's ``csrc/flash_attention.cu``
as it is and four variants, each with one text edit: ``nomask`` (no
per-score mask on a key tile inside every row's range of the block),
``constp`` (a constant p in place of the exponent), ``nopv`` (no P V
product), ``reversed`` (the blocks in descending M tile order, every (kv
head, sample) of a tile before the next). The variants compute wrong
outputs; they are timed only. Each runs at B 1, S 32,768, 15 / 5 heads
(causal) and at hymba's rung 2048 (B 8, 25 / 5 heads, ragged, window
2048), two turns, one graph-replay read each (``chip_smoke.graph_ms``).
Prints one JSON object a shape. Needs a CUDA device and ``nvcc``."""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate"

EDITS = {
    "base": [],
    "nomask": [
        ("        if (key < klo[hh] || key >= khi[hh]) s[n][e] = -INFINITY;",
         "        if (!tile_free && (key < klo[hh] || key >= khi[hh])) "
         "s[n][e] = -INFINITY;"),
        ("    // mask each M-row by its own limits; online softmax once per "
         "tile\n",
         "    const bool tile_free = t0 >= q_offset + row_hi - w + 1 &&\n"
         "        t0 + kKTile <= (causal ? min(kvv, q_offset + row_lo + 1) "
         ": kvv);\n")],
    "constp": [("const float p = __expf(s[n][e] - base[e >> 1]);",
                "const float p = 0.5f;")],
    "nopv": [("        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);\n"
              "        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);", "")],
    "reversed": [(
        "  const int tile = blockIdx.x;\n  const int kh = blockIdx.y;\n"
        "  const int b = blockIdx.z;",
        "  const int lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y "
        "* blockIdx.z);\n  const int per = gridDim.y * gridDim.z;\n"
        "  const int tile = gridDim.x - 1 - lin / per;\n"
        "  const int kh = (lin % per) % gridDim.y;\n"
        "  const int b = (lin % per) / gridDim.y;")],
}


def build(src: str):
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"flash_ablation: {name}: edit not found")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_ablation: nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_bf16
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    checkout = Path(sys.argv[1]).resolve()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("flash_ablation: needs a CUDA device")
    src = (checkout / "src/repro_torch/csrc/flash_attention.cu").read_text()
    libs = build(src)
    import chip_smoke as cs
    from repro_torch.kernels import softmax_scale
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for name, B, S, Hq, Hkv, D, lens, window in (
            ("B 1, S 32768, 15 / 5 heads, causal", 1, 32768, 15, 5, 64, None,
             0),
            ("hymba rung 2048", 8, 2048, 25, 5, 64,
             [2048, 1600, 1030, 2048, 600, 1280, 2040, 2035], 2048)):
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        kv = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=dev)
        out = torch.empty_like(q)
        m_tiles = -(-S * (Hq // Hkv) // 64)
        row = dict(shape=name)
        for _ in range(2):
            for variant, fn in libs.items():
                def call(fn=fn):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             None if kv is None else kv.data_ptr(),
                             out.data_ptr(), B, S, S, Hq, Hkv, D, 1, window, 0,
                             512, 1024, softmax_scale(None, D), m_tiles,
                             320 * (D + 8) * 2,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{variant}: cudaError_t {err}")
                row.setdefault(variant, []).append(
                    cs.graph_ms(call, reps=5 if S > 8192 else 20))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
