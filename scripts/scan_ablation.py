"""An ssd_scan kernel of the checkout given (e.g. the parent commit unpacked
with ``git archive`` into ``build/parent``) with one part taken out at a
time, to see which part its time goes to::

    python3 scripts/scan_ablation.py CHECKOUT [--chunked]

Builds, under ``build/ablate_scan``, the checkout's ``csrc/ssd_scan.cu`` as
it is and variants, each with one text edit. By default the serial kernel
(the one that walks a (b, h)'s chunks in order in one block):
``nostate`` (no state read q . S), ``nopv`` (no intra-chunk P V), ``noqk``
(no q k^T products), ``noupdate`` (no state update k_scaled^T v),
``onechunk`` (every chunk but the first left out). With ``--chunked``, the
chunked instance's three launches: ``nolocal``, ``nocarry``, ``noy`` (one
launch left out), ``nokeys`` (y without its key tiles: staging, state reads
and stores only), ``nopv`` (y without P v), ``nodecay`` (the scores
undecayed: no exp), ``nopdl`` (no programmatic dependent launch). The
variants compute wrong outputs; they are timed only. Each runs at hymba's
rung 2048 (B 8, S 2048, 25 heads, dk 16, dv 64, 8 chunks of 256, carried
state), its exact prompt (B 1, S 3072, 12 chunks) and its tensor-parallel
ranks' rung 128 (B 8, 7 and 13 heads, one chunk), two turns, one
graph-replay read each (``chip_smoke.graph_ms``). Prints one JSON object a
shape. Needs a CUDA device and ``nvcc``."""

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate_scan"

EDITS = {
    "base": [],
    "nostate": [("for (int m = 0; m < MR; ++m) fma4(acc[m], qf[m][kk], s);",
                 "for (int m = 0; m < MR; ++m) (void)s;")],
    "nopv": [("              fma4(acc[m], x == 0 ? p[m].x : x == 1 ? p[m].y "
              ": x == 2 ? p[m].z : p[m].w, vv);", "(void)vv;")],
    "noqk": [("          mma_bf16(sc[0], a0, a1, a2, a3, kf0[c], kf0[c + 4]);\n"
              "          mma_bf16(sc[1], a0, a1, a2, a3, kf1[c], kf1[c + 4]);",
              "")],
    "noupdate": [("""            float (&d)[8] = dacc[j + x];
            d[0] = fmaf(av[x], v0.x, d[0]);
            d[1] = fmaf(av[x], v0.y, d[1]);
            d[2] = fmaf(av[x], v0.z, d[2]);
            d[3] = fmaf(av[x], v0.w, d[3]);
            d[4] = fmaf(av[x], v1.x, d[4]);
            d[5] = fmaf(av[x], v1.y, d[5]);
            d[6] = fmaf(av[x], v1.z, d[6]);
            d[7] = fmaf(av[x], v1.w, d[7]);""", "")],
    "onechunk": [("for (int ci = 0; ci < nc; ++ci) {",
                  "for (int ci = 0; ci < 1; ++ci) {")],
}
CHUNKED_EDITS = {
    "base": [],
    "nolocal": [("  ssd_local_kernel<DKP><<<", "  if (0) ssd_local_kernel<DKP><<<")],
    "nocarry": [("    e = cudaLaunchKernelEx(&cfg, ssd_carry_kernel,",
                 "    if (0) e = cudaLaunchKernelEx(&cfg, ssd_carry_kernel,")],
    "noy": [("  e = cudaLaunchKernelEx(&cfg, ssd_y_kernel<DKP>,",
             "  if (0) e = cudaLaunchKernelEx(&cfg, ssd_y_kernel<DKP>,")],
    "nokeys": [("    for (int t = 0; t < nkt; ++t) {\n      const int u0 = t * kCKeys;",
                "    for (int t = 0; t < 0; ++t) {\n      const int u0 = t * kCKeys;")],
    "nopv": [("            fma8(acc[m], pv, v0, v1);", "            (void)pv;")],
    "nodecay": [("sc[n][e] * expf(cw - cum_s[u] + li_s[u])", "sc[n][e]")],
    "nopdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
}

# (label, B, S, H, carried state)
SHAPES = [("hymba rung 2048", 8, 2048, 25, True),
          ("hymba exact prompt", 1, 3072, 25, False),
          ("hymba TP rank rung 128, 7 heads", 8, 128, 7, False),
          ("hymba TP rank rung 128, 13 heads", 8, 128, 13, False)]


def build(src: str, edits_by_name: dict, entry: str, nargs: tuple):
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in edits_by_name.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"scan_ablation: {name}: edit not found")
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
            raise SystemExit(f"scan_ablation: nvcc failed on {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(OUT / f"{name}.so")), entry)
        fn.argtypes = ([ctypes.c_void_p] * nargs[0] + [ctypes.c_int] * nargs[1]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    checkout = Path(sys.argv[1]).resolve()
    chunked = "--chunked" in sys.argv[2:]
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scan_ablation: needs a CUDA device")
    src = (checkout / "src/repro_torch/csrc/ssd_scan.cu").read_text()
    if chunked:
        libs = build(src, CHUNKED_EDITS, "ssd_scan_chunked_bf16", (9, 9))
    else:
        libs = build(src, EDITS, "ssd_scan_bf16", (8, 8))
    # the checkout's own launch geometry (state columns, shared memory)
    spec = importlib.util.spec_from_file_location(
        "checkout_scan",
        checkout / "src/repro_torch/kernels/ssd_scan/ssd_scan.py")
    bind = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bind)
    import chip_smoke as cs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    dk, dv, W = 16, 64, 256
    for name, B, S, H, carried in SHAPES:
        q, k = (torch.randn((B, S, H, dk), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        v = torch.randn((B, S, H, dv), generator=gen, device=dev).bfloat16()
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device=dev))
        lf, li = -dt, torch.log(dt)
        s0 = (torch.randn((B, H, dk, dv), generator=gen, device=dev)
              if carried else None)
        y = torch.empty_like(v)
        st = torch.empty((B, H, dk, dv), device=dev)
        Wc = min(W, S)
        if chunked:
            geo = bind.geometry(B, H, dk, dv, Wc, S // Wc, bind.CHUNKED)
            ws = bind.workspace(geo, dev)
            launch = (None if ws is None else ws.data_ptr(), B, S, H, dk, dv,
                      Wc, geo.blocks, geo.local_smem, geo.smem_bytes)
        else:
            geo = bind.geometry(B, H, dk, dv, Wc)
            launch = (B, S, H, dk, dv, Wc, geo.cols, geo.smem_bytes)
        row = dict(shape=name, B=B, S=S, H=H, dk=dk, dv=dv, chunk=Wc,
                   blocks=geo.blocks)
        for _ in range(2):
            for variant, fn in libs.items():
                def call(fn=fn):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             lf.data_ptr(), li.data_ptr(),
                             None if s0 is None else s0.data_ptr(),
                             y.data_ptr(), st.data_ptr(), *launch,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{variant}: cudaError_t {err}")
                row.setdefault(variant, []).append(cs.graph_ms(call))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
