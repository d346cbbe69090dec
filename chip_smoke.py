"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit) if it fails:

1. build every kernel of the serving path from the checkout: the CUDA
   sources in ``src/repro_torch/csrc`` (one ``nvcc`` each, all at once,
   linked into one library under ``build/kernels/``) and the Triton
   RMSNorm;
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (tolerances below), and the attention kernels also
   at smollm's context (prefill S=1024 and 2048, decode Smax=2048); time
   kernel, plain version and the nearest single PyTorch call; print each
   attention launch's geometry (M tiles, cluster size, warps) and, at the
   headline shapes, each attention kernel's time over the library call's;
   print each ssd_scan case's geometry (state columns a block, grid, blocks
   per SM, waves) and its time over its bound; time decode attention at
   every cluster size and warp count it takes;
3. serve full-width smollm-360m (32 layers, seeded random weights, bf16)
   through ``LMServer``: 16 requests, slots=8, max_len=256, prompts of 8-200
   tokens, 32 new tokens each, greedy; the fused decode step runs eagerly
   once and then replays from its CUDA graph (checked); the launch counts
   are set to 0 just before and read just after, and each of its kernels'
   counts must rise;
4. with every slot busy: the host's split of one eager decode step
   (``torch.profiler``'s CPU events: Python and wrapper checks, aten
   dispatch, launch calls), then a B=8 prefill and four decode steps, eager
   and replayed from the graph, traced: device operations and device busy
   time per prefill and per decode step; ms per decode step, eager against
   graph, in turns over the same steps (whose tokens must agree);
5. streams in calibrated-simulation mode: the graphed step against the
   eager one, greedy and at temperature 0.8 (seed 0), equal bit for bit;
   ``fused=False`` (the reference per-slot loop) against the fused step,
   equal, with 1 + active slots host syncs per step;
6. compare the card's prefill logits and 8 teacher-forced decode steps with
   the same model on the CPU's plain path;
7. run ``examples/quickstart_torch.py``'s ``main()`` on the card (full-width
   smollm-360m, temperature 0.8): counts set to 0 before, and rising;
8. phases 3-6 for full-width xlstm-125m (6 mLSTM/sLSTM pairs, d_model 768,
   4 heads of 384, fp32 gates): 16 requests, slots=8, max_len=512, prompts
   of 8-480 tokens, 32 new tokens, greedy, with the ssd_scan and rmsnorm
   counts rising; prefill time per rung; the profile and timings; graph
   against eager streams; logits and every decode-state leaf against the
   CPU's plain path;
9. print the figures, the card's name and power limit, one ``kernels`` JSON
   line, and as the last line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits nonzero before printing anything. It imports
``torch`` and ``repro_torch`` only."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12       # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores
BF16_ULP = 2.0 ** -7
SMS = 132                        # H100 SXM streaming multiprocessors

# tolerances, kernel vs plain version on the same card inputs: the kernels
# sum in other orders (rmsnorm); decode attention keeps p in fp32, flash
# attention rescales per 64-key tile and sums P V in fp32 across tiles where
# the plain version rounds each key block's P V to bf16: one bf16 rounding
# of the value for rmsnorm and three bf16 roundings of 1 for attention
# outputs (averages of N(0, 1) values)
TOL = {"rmsnorm": (BF16_ULP, 1e-5),
       "decode_attention": (BF16_ULP, 3 * BF16_ULP),
       "flash_attention": (BF16_ULP, 3 * BF16_ULP)}
# ssd_scan: kernel and plain version sum fp32 products of up to dk (q . k,
# q . S) or a chunk (P v, k^T v) terms in other orders, so y (bf16) to one
# bf16 rounding plus SCAN_ATOL of its largest magnitude, the fp32 state to
# rtol 2e-5 plus SCAN_ATOL of its largest magnitude
SCAN_ATOL = 2e-5
# card vs CPU plain path, full model: 32 layers (smollm) or 6 pairs (xlstm)
# of bf16 rounding in other orders (cuBLAS and the kernels vs CPU GEMMs and
# the plain versions); the logits, and each xlstm decode-state leaf, may
# differ by this share of their largest magnitude: about twice the largest
# difference seen on an H100 (smollm logits 2.2 %; xlstm logits 0.63 %,
# state leaves 0.73 %)
LOGIT_TOL = {"smollm-360m": 0.05, "xlstm-125m": 0.015}
STATE_TOL = 0.015

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
    "decode_attention": "src/repro/kernels/decode_attention/decode_attention.py:71",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:76",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:58",
}
SOURCES = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/rmsnorm.py"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu"),
    "ssd_scan": ("cuda", "src/repro_torch/csrc/ssd_scan.cu"),
}
# the case of each kernel that stands in the kernels line (its serving shape)
HEADLINE = {"rmsnorm": 2, "decode_attention": 0, "flash_attention": 5,
            "ssd_scan": 4}


def log(*a):
    print(*a, flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _xlstm_state(cache):
    """The decode-state leaves of an xlstm cache, named."""
    names = ("mlstm_S", "mlstm_n", "slstm_c", "slstm_n", "slstm_h", "slstm_m")
    return dict(zip(names, [cache["m"][0], cache["m"][1], *cache["s"]],
                    strict=True))


def cuda_ms(fn, reps=50, warmup=5):
    """Mean time of ``fn()`` over ``reps`` back-to-back eager calls (CUDA
    events): the device time, or the host's launch time where the host
    cannot keep the device busy."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=5):
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so host launch
    cost drops out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(nbytes, *work):
    """Least ms for ``nbytes`` of device memory traffic and ``work``, pairs
    (flops, peak rate of their type) whose times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(flops / peak for flops, peak in work) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name, got, want, case):
    import torch
    rtol, atol = TOL[name]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(
            f"{name} {case}: {int(bad.sum())} elements beyond rtol={rtol} "
            f"atol={atol}; max_abs_err={float(err.max())}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def timings(kernel, plain, library=None):
    """Device times (CUDA graph replay) of the kernel's wrapper, its plain
    version and the library call, plus the kernel's eager time."""
    return dict(ms=graph_ms(kernel), eager_ms=cuda_ms(kernel),
                plain_ms=graph_ms(plain, reps=5),
                library_ms=None if library is None else graph_ms(library))


def sdpa(q, k, v, mask):
    """The one PyTorch call computing masked GQA attention (model layout
    in, heads-major views to SDPA), or None where this torch lacks
    ``enable_gqa``."""
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    try:
        call()
    except TypeError:
        return None
    return call


def kernel_cases(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.decode_attention import (
        block_warps, cluster_size)
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.flash_attention import geometry
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    out = {"rmsnorm": [], "decode_attention": [], "flash_attention": []}

    # rmsnorm: decode rows (8) and a full prefill batch (8 x 256), d = 960,
    # plain and with the residual add in front
    d = 960
    for n in (8, 2048):
        for residual in (False, True):
            x, w = randn((n, d)), randn((d,), 0.25) + 1
            r = randn((n, d)) if residual else None
            got = rmsnorm_op(x, w, residual=r)
            want = rmsnorm_ref(x, w, residual=r)
            pairs = zip(got, want) if residual else [(got, want)]
            case = f"N={n} d={d} residual={residual}"
            err = max(check("rmsnorm", g, e, case) for g, e in pairs)
            nbytes = (2 * n * d * 2 + d * 2) * (2 if residual else 1)
            lib = None
            if not residual and hasattr(F, "rms_norm"):
                lib = lambda: F.rms_norm(x, (d,), w, 1e-5)  # noqa: E731
            out["rmsnorm"].append(dict(
                case=case, max_abs_err=err,
                bound=bound(nbytes, (4 * n * d, FP32_FLOPS)),
                **timings(lambda: rmsnorm_op(x, w, residual=r),
                          lambda: rmsnorm_ref(x, w, residual=r), lib)))

    # decode: B=8 slots, 15/5 heads, D=64, Smax=256, mixed lengths incl. 0
    # and Smax, full attention and a window; then Smax=2048 (smollm's
    # context), lengths spread over 0-2048
    B, Hq, Hkv, D = 8, 15, 5, 64
    for Smax, window, lengths in (
            (256, 0, [0, 1, 37, 128, 200, 255, 256, 64]),
            (256, 32, [0, 1, 37, 128, 200, 255, 256, 64]),
            (2048, 0, [0, 1, 300, 1024, 2047, 2048, 1500, 700])):
        q = randn((B, 1, Hq, D))
        k, v = randn((B, Smax, Hkv, D)), randn((B, Smax, Hkv, D))
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        got = decode_attention_op(q, k, v, ln, window=window)
        want = decode_attention_ref(q, k, v, ln, window=window)
        case = f"B={B} Hq={Hq} Hkv={Hkv} D={D} Smax={Smax} window={window}"
        err = check("decode_attention", got, want, case)
        # positions each sample reads: [max(0, len - window), min(len, Smax))
        used = [min(n, Smax) - (max(0, n - window) if window else 0)
                for n in lengths]
        nbytes = 2 * B * Hq * D * 2 + B * 4 + 2 * sum(used) * Hkv * D * 2
        flops = 4 * Hq * D * sum(used)
        pos = torch.arange(Smax, device=dev)
        lo = (ln - window).clamp_min(0) if window else torch.zeros_like(ln)
        mask = ((pos[None] < ln[:, None])
                & (pos[None] >= lo[:, None]))[:, None, None, :]
        c = cluster_size(B, Hkv, Smax, window)
        out["decode_attention"].append(dict(
            case=case, max_abs_err=err,
            geometry=f"cluster C={c}, grid ({c}, {Hkv}, {B}) = "
                     f"{c * Hkv * B} blocks of "
                     f"{block_warps(Smax, window, c)} warps",
            bound=bound(nbytes, (flops, BF16_TENSOR_FLOPS)),
            **timings(lambda: decode_attention_op(q, k, v, ln, window=window),
                      lambda: decode_attention_ref(q, k, v, ln,
                                                   window=window),
                      sdpa(q, k, v, mask))))

    # flash prefill: B in {1, 8}, Sq = Sk in {8, 24 (ragged, one empty
    # prompt), 256}, kv_valid as the ladder-padded prefill passes it; then
    # B=8 at 1024 and 2048 (smollm's context), ragged
    flash_lens = {8: [8, 5, 8, 3, 7, 8, 1, 6],
                  24: [24, 17, 3, 0, 24, 9, 20, 12],
                  256: [256, 200, 129, 256, 131, 140, 250, 180],
                  1024: [1024, 800, 517, 1024, 300, 640, 900, 1000],
                  2048: [2048, 1600, 1030, 2048, 600, 1280, 1800, 2000]}
    for S, B in ((8, 1), (8, 8), (24, 1), (24, 8), (256, 1), (256, 8),
                 (1024, 8), (2048, 8)):
        lens = flash_lens[S][:B]
        q = randn((B, S, Hq, D))
        k, v = randn((B, S, Hkv, D)), randn((B, S, Hkv, D))
        kv = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = flash_attention_op(q, k, v, kv_valid=kv)
        want = flash_attention_ref(q, k, v, kv_valid=kv)
        case = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} kv_valid={lens}"
        err = check("flash_attention", got, want, case)
        # keys each row attends: causal and below kv_valid
        n_valid = sum(min(r + 1, n) for n in lens for r in range(S)) * Hq
        # bytes: q read and out written for every row; K and V rows
        # below kv_valid (the last row's causal walk reaches them all);
        # a sample with kv_valid == 0 reads only V, the mean over the key
        # blocks the plain path visits, all S rows at S <= 512
        kv_rows = sum(2 * n if n else S for n in lens)
        nbytes = 2 * B * S * Hq * D * 2 + kv_rows * Hkv * D * 2 + B * 4
        pos = torch.arange(S, device=dev)
        mask = ((pos[None, :] <= pos[:, None])[None]
                & (pos[None, None, :] < kv[:, None, None]))[:, None]
        geo = geometry(B, S, Hq, Hkv, D)
        out["flash_attention"].append(dict(
            case=case, max_abs_err=err,
            geometry=f"{geo.m_tiles} M tiles of 64 (row, head) pairs, "
                     f"grid ({geo.m_tiles}, {Hkv}, {B}) = {geo.blocks} "
                     f"blocks, {geo.smem_bytes} B shared memory",
            bound=bound(nbytes, (4 * D * n_valid, BF16_TENSOR_FLOPS)),
            **timings(lambda: flash_attention_op(q, k, v, kv_valid=kv),
                      lambda: flash_attention_ref(q, k, v, kv_valid=kv),
                      sdpa(q, k, v, mask))))
    return out


def decode_sweep(dev):
    """decode_attention through its C entry point at every cluster size and
    warp count it takes (not the wrapper's choice): smollm's decode shape
    with lengths 0-256, the same with every length 0 (the launch's fixed
    cost: no position is read) and Smax=2048 at C=8. Each launch with
    lengths is held against the plain version. What ``cluster_size`` and
    ``block_warps`` are chosen from; these launches bypass the wrapper and
    its count."""
    import torch
    from repro_torch.kernels import softmax_scale
    from repro_torch.kernels.decode_attention import decode_attention as bind
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device=dev).manual_seed(99)
    B, Hq, Hkv, D = 8, 15, 5, 64
    rows = []
    for Smax, lengths, geos in (
            (256, [0, 1, 37, 128, 200, 255, 256, 64],
             [(c, w) for c in (1, 2, 4, 8) for w in (2, 4)]),
            (256, [0] * 8, [(c, w) for c in (1, 8) for w in (2, 4)]),
            (2048, [0, 1, 300, 1024, 2047, 2048, 1500, 700],
             [(8, 2), (8, 4)])):
        q = torch.randn((B, Hq, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Smax, Hkv, D), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        want = decode_attention_ref(q.view(B, 1, Hq, D), k, v, ln)
        out = torch.empty_like(q)
        for c, warps in geos:
            def call():
                err = bind._fn()(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), ln.data_ptr(),
                    out.data_ptr(), B, Smax, Hkv, Hq // Hkv, D, 0,
                    softmax_scale(None, D), c, warps,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"decode_attention C={c} warps="
                                       f"{warps}: cudaError_t {err}")
            call()
            case = (f"Smax={Smax} lengths={min(lengths)}-{max(lengths)} "
                    f"C={c} warps={warps}")
            check("decode_attention", out.view(B, 1, Hq, D), want, case)
            rows.append((case, graph_ms(call)))
    return rows


def scan_bound(B, S, H, dk, dv, W, state_in):
    """Least time of one chunked scan: bytes of q, k, v, y (bf16), the
    gates and the fp32 state (in where given, out), against the work it
    needs per chunk: the causal half of q k^T (bf16 inputs, fp32 sums: the
    tensor cores' rate), and in fp32 the causal half of P v and per step
    the state read (q . S) and the state update (k^T v)."""
    nbytes = (2 * (B * S * H * dk) + 2 * (B * S * H * dv)) * 2 \
        + 2 * B * S * H * 4 + B * H * dk * dv * 4 * (2 if state_in else 1)
    causal = (S // W) * W * (W + 1) // 2
    return bound(nbytes, (2 * B * H * causal * dk, BF16_TENSOR_FLOPS),
                 (2 * B * H * (causal * dv + 2 * S * dk * dv), FP32_FLOPS))


def scan_cases(dev):
    """ssd_scan against its plain version at the xlstm prefill's shapes:
    (a) B=8 S=256 H=4 dk=dv=384 with padded gates and a zero state, (b) the
    normalizer alone (dv=1), (c) S=512 in two chunks from a nonzero state,
    (d) B=1 S=8, (e) the launch the mLSTM makes: (a) with v augmented by
    the normalizer's ones column (dv=385)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import geometry
    from repro_torch.models.linear_core import pad_mask_gates

    gen = torch.Generator(device=dev).manual_seed(4321)
    H, hd, chunk = 4, 384, 256
    lens = {8: [8], 256: [256, 200, 129, 256, 131, 140, 250, 180],
            512: [512, 300, 257, 480, 90, 512, 400, 333]}
    rows = []
    for tag, B, S, dv, state in (("a", 8, 256, hd, "zero"),
                                 ("b", 8, 256, 1, "zero"),
                                 ("c", 8, 512, hd, "random"),
                                 ("d", 1, 8, hd, "zero"),
                                 ("e", 8, 256, hd + 1, "zero")):
        def randn(shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        # q, k scaled by hd**-0.5 and sigmoid gates, as the mLSTM makes them
        q = randn((B, S, H, hd), hd ** -0.5).to(torch.bfloat16)
        k = randn((B, S, H, hd), hd ** -0.5).to(torch.bfloat16)
        v = randn((B, S, H, dv)).to(torch.bfloat16)
        if dv == hd + 1:
            v[..., -1] = 1
        raw = randn((2, B, S, H))
        vl = torch.tensor(lens[S][:B], dtype=torch.int32, device=dev)
        lf, li = pad_mask_gates(F.logsigmoid(raw[0] + 4.0),
                                F.logsigmoid(raw[1]), vl)
        s0 = (torch.zeros((B, H, hd, dv), device=dev) if state == "zero"
              else randn((B, H, hd, dv)))
        args = (q, k, v, lf, li)
        y, st = ssd_scan_op(*args, chunk=chunk, initial_state=s0)
        yr, sr = ssd_scan_ref(*args, chunk=chunk, initial_state=s0)
        case = (f"({tag}) B={B} S={S} H={H} dk={hd} dv={dv} chunk="
                f"{min(chunk, S)} lengths={lens[S][:B]} {state} state")
        errs = []
        for name, got, want, rtol in (("y", y, yr, BF16_ULP),
                                      ("state", st, sr, 2e-5)):
            g, w = got.float(), want.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"ssd_scan {case}: non-finite {name}")
            err = (g - w).abs()
            atol = SCAN_ATOL * float(w.abs().max())
            bad = err > atol + rtol * w.abs()
            if bad.any():
                raise AssertionError(
                    f"ssd_scan {case}: {int(bad.sum())} {name} elements "
                    f"beyond rtol={rtol} atol={atol}; max_abs_err="
                    f"{float(err.max())}")
            errs.append(float(err.max()))
        geo = geometry(B, H, hd, dv, min(chunk, S))
        rows.append(dict(
            case=case, max_abs_err=errs[0], state_max_abs_err=errs[1],
            geometry=f"{geo.cols} state columns a block, grid {geo.grid} = "
                     f"{geo.blocks} blocks of {geo.threads} threads, "
                     f"{geo.smem_bytes} B shared memory, {geo.blocks_per_sm} "
                     f"block(s) per SM, {geo.waves:.3f} waves on {SMS} SMs",
            bound=scan_bound(B, S, H, hd, dv, min(chunk, S), True),
            **timings(lambda: ssd_scan_op(*args, chunk=chunk,
                                          initial_state=s0),
                      lambda: ssd_scan_ref(*args, chunk=chunk,
                                           initial_state=s0))))
    return rows


# ---------------------------------------------------------------------------
# phases 3-6: the serving paths at full width, and parity with the CPU
# ---------------------------------------------------------------------------

def kernel_ops():
    from repro_torch.kernels.decode_attention.ops import decode_attention_op
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
    return {"rmsnorm": rmsnorm_op, "decode_attention": decode_attention_op,
            "flash_attention": flash_attention_op, "ssd_scan": ssd_scan_op}


def serve(model, params, dev, *, kernels, max_len, max_prompt, slo=0.5):
    """16 requests (prompts of 8..max_prompt tokens, 32 new tokens each,
    greedy) through ``LMServer`` with 8 slots; every count of ``kernels`` is
    set to 0 just before the run and must have risen just after. Then the
    same requests with the fused step eager every step, for its tokens/s."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import LMServer

    ops = {name: kernel_ops()[name] for name in kernels}
    rng = np.random.default_rng(0)
    vocab = model.cfg.vocab_size

    def make_server():
        return LMServer(model, device=dev, slots=8, max_len=max_len,
                        slo=slo, temperature=0.0, seed=0)

    # warm-up: cuBLAS handles, Triton compile, allocator; not measured
    warm = make_server()
    for n in (8, 100):
        warm.submit(rng.integers(0, vocab, size=n), max_new_tokens=4)
    warm.run(params)
    torch.cuda.synchronize()

    srv = make_server()
    prompts = [rng.integers(0, vocab, size=int(n))
               for n in rng.integers(8, max_prompt + 1, size=16)]
    rids = [srv.submit(p, max_new_tokens=32) for p in prompts]
    decode_s = []
    inner = srv._decode_once

    def timed_decode(params):
        t0 = time.perf_counter()
        inner(params)                 # ends in the packed host copy
        if srv.decode_steps > len(decode_s):
            decode_s.append(time.perf_counter() - t0)

    srv._decode_once = timed_decode
    for op in kernel_ops().values():
        op.launches = 0
    t0 = time.perf_counter()
    srv.run(params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: op.launches for name, op in kernel_ops().items()}
    for name in ops:
        if launches[name] <= 0:
            raise AssertionError(f"{name}: no kernel launch on the main path")
    done = [srv.completed[r] for r in rids]
    if len(done) != 16 or any(len(r.tokens) != 32 for r in done):
        raise AssertionError("not every request completed with 32 tokens")
    if any(not 0 <= t < vocab for r in done for t in r.tokens):
        raise AssertionError("token out of vocabulary")
    st = srv.stats
    if st["host_syncs_per_decode_step"] != 1.0:
        raise AssertionError(f"host syncs per decode step: {st}")
    # the first step with these weights runs eagerly, every later one is a
    # replay of the captured graph
    if srv.graph_replays != st["decode_steps"] - 1:
        raise AssertionError(f"{srv.graph_replays} graph replays in "
                             f"{st['decode_steps']} decode steps")
    tokens = sum(len(r.tokens) for r in done)
    # the same requests with the fused step run eagerly every step (the
    # step as it ran before it was captured): tokens/s in the same call
    eager = make_server()
    _eager(eager)
    for p in prompts:
        eager.submit(p, max_new_tokens=32)
    t0 = time.perf_counter()
    eager.run(params)
    torch.cuda.synchronize()
    eager_wall = time.perf_counter() - t0
    if sum(len(r.tokens) for r in eager.completed.values()) != tokens:
        raise AssertionError("the eager run did not complete every request")
    return dict(launches=launches, wall_s=wall, tokens=tokens,
                eager_tokens_per_s=tokens / eager_wall,
                decode_steps=st["decode_steps"],
                graph_replays=srv.graph_replays,
                decode_ms_per_step=1e3 * sum(decode_s) / len(decode_s),
                tokens_per_s=tokens / wall,
                prefill_dispatches=st["prefill_dispatches"],
                rung_dispatches=dict(srv.rung_dispatches))


def prefill_rungs(model, params, dev, *, max_len, rungs=None):
    """Host-clock ms of one B=8 ladder-padded prefill per rung (median of 3,
    ending in a synchronise); every rung of the ladder unless ``rungs``."""
    import numpy as np
    import torch
    from repro_torch.core.batching import prompt_length_ladder

    rng = np.random.default_rng(1)
    out = {}
    for rung in rungs or prompt_length_ladder(max_len):
        toks = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, size=(8, rung)).astype(np.int32)).to(dev)
        lens = torch.full((8,), rung, dtype=torch.int32, device=dev)
        lens[1::2] = max(1, rung - rung // 3)
        batch = {"tokens": toks, "lengths": lens}
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, batch, max_len=max_len)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not torch.isfinite(logits.float()).all():
            raise AssertionError(f"prefill rung {rung}: non-finite logits")
        out[rung] = 1e3 * sorted(times)[1]
    return out


def _union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _busy_server(model, params, dev, *, max_len, max_prompt, slo, seed=3):
    """A server with all 8 slots busy (64 new tokens each to come)."""
    import numpy as np
    from repro_torch.serving.engine import LMServer

    rng = np.random.default_rng(seed)
    vocab = model.cfg.vocab_size
    srv = LMServer(model, device=dev, slots=8, max_len=max_len, slo=slo,
                   temperature=0.0, seed=0)
    for n in rng.integers(8, max_prompt + 1, size=8):
        srv.submit(rng.integers(0, vocab, size=int(n)), max_new_tokens=64)
    for _ in range(8):                 # AIMD may admit fewer at a time
        if len(srv._active) < 8:
            srv._admit(params)
    if len(srv._active) != 8:
        raise AssertionError(f"server holds {len(srv._active)} requests, "
                             f"not 8")
    return srv


def _eager(srv):
    """Make ``srv`` run its fused step eagerly (the step its graph
    captures); ``_graphed`` undoes it."""
    srv._decode_device = lambda params: srv._decode_fused(
        params, *srv._slot_state())


def _graphed(srv):
    srv.__dict__.pop("_decode_device", None)


def host_split(srv, params):
    """Where the host's time goes in one eager fused decode step, from
    ``torch.profiler``'s CPU-side events: the step's wall time under the
    profiler; the CUDA API calls (kernel launches apart);
    aten operators outside those calls (PyTorch dispatch and its CPU work);
    and the rest: Python, the model code and the kernel wrappers' checks.
    The profiler's own per-event cost lands in each part."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    _eager(srv)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("decode_step"):
            packed = srv._decode_device(params)
        torch.cuda.synchronize()
    packed.cpu()
    _graphed(srv)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    step = next(e for e in events if e.name == "decode_step")
    lo, hi = step.time_range.start, step.time_range.end
    inside = [e for e in events if e is not step
              and lo <= e.time_range.start and e.time_range.end <= hi]

    def spans(pred):
        return [(e.time_range.start, e.time_range.end) for e in inside
                if pred(e.name)]

    def runtime(n):
        return n.startswith("cuda") or n.startswith("cu") and n[2:3].isupper()

    def launch(n):
        return runtime(n) and "Launch" in n

    aten, calls = spans(lambda n: n.startswith("aten::")), spans(runtime)
    wall = hi - lo
    both = _union_us(aten + calls)
    return dict(
        wall_ms=wall / 1e3,
        launch_calls=len(spans(launch)),
        launch_ms=_union_us(spans(launch)) / 1e3,
        other_runtime_ms=(_union_us(calls) - _union_us(spans(launch))) / 1e3,
        aten_ms=(both - _union_us(calls)) / 1e3,
        python_ms=(wall - both) / 1e3,
        aten_ops=sum(1 for e in inside if e.name.startswith("aten::")
                     and not (e.cpu_parent and e.cpu_parent.name.startswith(
                         "aten::"))))


def device_profile(model, params, dev, *, max_len, max_prompt, steps=4,
                   slo=0.5):
    """A B=8 ladder-padded prefill at rung 256, and ``steps`` decode steps
    of a server with all 8 slots busy, eager and then replayed from the
    CUDA graph, each under ``torch.profiler``: device operations (kernels,
    copies) per prefill and per decode step, and the device's busy time in
    each (the union of their intervals); before the capture, the host's
    split of one eager step (``host_split``). A trace with no device
    events gives None."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    vocab = model.cfg.vocab_size
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, vocab, size=(8, 256)).astype(np.int32)).to(dev),
             "lengths": torch.from_numpy(rng.integers(
                 129, 257, size=8).astype(np.int32)).to(dev)}
    srv = _busy_server(model, params, dev, max_len=max_len,
                       max_prompt=max_prompt, slo=slo)

    def traced(fn, n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn(params)
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not ops:
            return None
        busy_us = _union_us([(o.time_range.start, o.time_range.end)
                             for o in ops])
        kernels = [o for o in ops if not o.name.startswith("Mem")]
        return dict(device_ops=len(ops) / n, kernels=len(kernels) / n,
                    busy_ms=busy_us / 1e3 / n)

    split = host_split(srv, params)
    _eager(srv)
    eager = traced(srv._decode_once, steps)
    _graphed(srv)
    for _ in range(2):                 # the eager step, then the capture
        srv._decode_once(params)
    if srv.graph_replays != 1:
        raise AssertionError("the profiled server did not capture its step")
    return dict(prefill=traced(lambda p: model.prefill(p, batch,
                                                       max_len=max_len), 1),
                decode=traced(srv._decode_once, steps),
                decode_eager=eager, host_split=split)


def eager_vs_graph(model, params, dev, *, max_len, max_prompt, steps=16,
                   slo=0.5):
    """ms per decode step (host clock, each step ending in its packed host
    copy) of one server with all 8 slots busy, its fused step eager and
    replayed from the graph, in turns (eager, graph, graph, eager), each
    turn from the same slot state; the greedy tokens of every turn must be
    equal."""
    import torch

    srv = _busy_server(model, params, dev, max_len=max_len,
                       max_prompt=max_prompt, slo=slo, seed=4)
    for _ in range(2):                 # the eager step, then the capture
        srv._decode_once(params)
    state = list(_leaves(srv._slot_state()))
    snap = [t.clone() for t in state]
    ms, toks = {"eager": [], "graph": []}, []
    for mode in ("eager", "graph", "graph", "eager"):
        for t, s in zip(state, snap):
            t.copy_(s)
        (_eager if mode == "eager" else _graphed)(srv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            srv._decode_once(params)
        ms[mode].append(1e3 * (time.perf_counter() - t0) / steps)
        toks.append([r.tokens[-steps:] for _, r in sorted(
            srv._active.items())])
    _graphed(srv)
    if len(srv._active) != 8 or any(t != toks[0] for t in toks):
        raise AssertionError("eager and graphed steps disagree")
    return ms


def token_parity(model, params, dev, *, max_len, max_prompt,
                 reference=False):
    """8 requests (prompts of 8..max_prompt tokens, 16 new tokens each)
    through servers in calibrated-simulation mode (admission does not
    depend on wall time): the graphed fused step against the eager one at
    temperature 0 and at 0.8 (seed 0), streams equal bit for bit; with
    ``reference``, also ``fused=False`` against the graphed fused step
    (both with the reference loop's same-length prompt groups), streams
    equal and 1 + active slots host syncs per step."""
    import numpy as np
    from repro_torch.core.metrics import VirtualClock
    from repro_torch.serving.engine import LMServer

    rng = np.random.default_rng(5)
    vocab = model.cfg.vocab_size
    prompts = [rng.integers(0, vocab, size=int(n))
               for n in rng.integers(8, max_prompt + 1, size=8)]

    def run(graph=True, **kw):
        srv = LMServer(model, device=dev, slots=8, max_len=max_len, seed=0,
                       clock=VirtualClock(),
                       service_model=lambda kind, b, t: 1e-5 * (1 + b * t),
                       **kw)
        if not graph:
            _eager(srv)
        rids = [srv.submit(p, max_new_tokens=16) for p in prompts]
        t0 = time.perf_counter()
        srv.run(params)
        wall = time.perf_counter() - t0
        toks = [srv.completed[r].tokens for r in rids]
        if any(len(t) != 16 for t in toks):
            raise AssertionError("a request did not complete its 16 tokens")
        if graph and kw.get("fused", True) and srv.graph_replays == 0:
            raise AssertionError("the fused step never replayed its graph")
        return toks, srv, wall

    out = {}
    for temp in (0.0, 0.8):
        graphed, eager = (run(graph=g, temperature=temp)[0]
                          for g in (True, False))
        if graphed != eager:
            raise AssertionError(f"graphed and eager streams differ at "
                                 f"temperature {temp}")
        out[f"graph_eq_eager_T{temp}"] = True
    if reference:
        fused, fsrv, fwall = run(temperature=0.0, pad_prompts=False)
        ref, rsrv, rwall = run(temperature=0.0, fused=False)
        if ref != fused:
            raise AssertionError("fused=False streams differ from the fused "
                                 "run's")
        want = rsrv.decode_steps + sum(len(t) - 1 for t in ref)
        if rsrv.decode_host_syncs != want:
            raise AssertionError(f"fused=False: {rsrv.decode_host_syncs} "
                                 f"host syncs, not 1 + active slots ({want})")
        out.update(reference_eq_fused=True,
                   reference_syncs_per_step=rsrv.stats[
                       "host_syncs_per_decode_step"],
                   reference_ms_per_step=1e3 * rwall / rsrv.decode_steps,
                   fused_ms_per_step=1e3 * fwall / fsrv.decode_steps)
    return out


def run_quickstart(dev):
    """``examples/quickstart_torch.py``'s ``main()`` on the card (full-width
    smollm-360m, temperature 0.8); the launch counts are set to 0 just
    before and read just after."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for op in kernel_ops().values():
        op.launches = 0
    t0 = time.perf_counter()
    srv = mod.main(["--device", str(dev)])
    wall = time.perf_counter() - t0
    launches = {name: op.launches for name, op in kernel_ops().items()}
    for name in ("rmsnorm", "decode_attention", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"quickstart: no {name} launch")
    if (len(srv.completed) != 24
            or any(len(r.tokens) != 24 for r in srv.completed.values())):
        raise AssertionError("quickstart: not every request completed")
    if (srv.stats["host_syncs_per_decode_step"] != 1.0
            or srv.graph_replays != srv.decode_steps - 1):
        raise AssertionError(f"quickstart: {srv.stats}, "
                             f"{srv.graph_replays} graph replays")
    return dict(launches=launches, wall_s=wall,
                decode_steps=srv.decode_steps)


def cpu_parity(cfg, params, dev, *, state=None):
    """Prefill + 8 teacher-forced decode steps on the card and on the CPU's
    plain path, same weights and tokens (one prompt padded); max |logit
    difference| over the largest |logit|. With ``state`` (cache -> named
    leaves), every leaf after the prefill and after the last step too, each
    over its own largest magnitude."""
    import numpy as np
    import torch
    from repro_torch.models.api import build_model

    cpu_model = build_model(cfg, device="cpu")
    gpu_model = build_model(cfg, device=dev)
    cpu_params = _tree_to(params, "cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    lens = np.array([64, 37], np.int32)
    feeds = rng.integers(0, cfg.vocab_size, size=(8, 2, 1)).astype(np.int32)
    results, states = [], []
    for model, p, d in ((gpu_model, params, dev), (cpu_model, cpu_params, "cpu")):
        logits, cache = model.prefill(
            p, {"tokens": torch.from_numpy(toks).to(d),
                "lengths": torch.from_numpy(lens).to(d)}, max_len=80)
        # clone: on the CPU .float().cpu() of an fp32 leaf is the leaf
        # itself, which the decode steps below update in place
        snaps = [] if state is None else [
            {k: t.float().cpu().clone() for k, t in state(cache).items()}]
        seq = [logits.float().cpu()]
        ln = torch.from_numpy(lens).to(d)
        for t in feeds:
            logits, cache = model.decode_step(p, cache,
                                              torch.from_numpy(t).to(d), ln)
            ln = ln + 1
            seq.append(logits.float().cpu())
        if state is not None:
            snaps.append({k: t.float().cpu().clone()
                          for k, t in state(cache).items()})
        results.append(torch.stack(seq))
        states.append(snaps)
    gpu, cpu = results
    if not torch.isfinite(gpu).all():
        raise AssertionError("non-finite logits on the card")
    scale = float(cpu.abs().max())
    err = (gpu - cpu).abs().amax(dim=(1, 2))
    rel = [float(e) / scale for e in err]
    if max(rel) > LOGIT_TOL[cfg.name]:
        raise AssertionError(f"card vs CPU logits: max |diff| / max |logit| "
                             f"= {max(rel)} > {LOGIT_TOL[cfg.name]} ({rel})")
    agree = float((gpu.argmax(-1) == cpu.argmax(-1)).float().mean())
    out = dict(prefill_rel_err=rel[0], decode_rel_err=rel[1:],
               logit_scale=scale, argmax_agreement=agree)
    for when, g, c in zip(("prefill", "decode"), *states):
        for name in c:
            if not torch.isfinite(g[name]).all():
                raise AssertionError(f"non-finite {name} on the card")
            e = float((g[name] - c[name]).abs().max()
                      / c[name].abs().max().clamp_min(1e-30))
            if e > STATE_TOL:
                raise AssertionError(
                    f"card vs CPU state {name} after {when}: max |diff| / "
                    f"max |leaf| = {e} > {STATE_TOL}")
            out[f"{name}_{when}_rel_err"] = e
    return out


def report_path(label, run, rungs, prof, parity, per_prefill, per_step,
                timing, tokens):
    log(f"{label} serve: {run['tokens']} tokens in {run['wall_s']:.3f} s "
        f"({run['tokens_per_s']:.1f} tok/s; the same requests with every "
        f"step eager {run['eager_tokens_per_s']:.1f} tok/s), "
        f"{run['decode_steps']} decode "
        f"steps ({run['graph_replays']} replayed from the CUDA graph) at "
        f"{run['decode_ms_per_step']:.3f} ms/step; "
        f"{run['prefill_dispatches']} prefill dispatches, per rung "
        f"{run['rung_dispatches']}")
    launches = run["launches"]
    steps, prefills = run["decode_steps"], run["prefill_dispatches"]
    log(f"{label} launches on its main path: {launches}; per decode step: "
        + ", ".join(f"{k} {launches[k] / steps}" for k in per_step)
        + "; per prefill: "
        + ", ".join(f"{k} {launches[k] / prefills}" for k in per_prefill)
        + f"; per decode step or prefill: rmsnorm "
        f"{launches['rmsnorm'] / (steps + prefills)}")
    log(f"{label} prefill ms per rung (B=8): "
        + ", ".join(f"{k}: {v:.3f}" for k, v in rungs.items()))
    e, g = timing["eager"], timing["graph"]
    eager_ms, graph_ms_ = sum(e) / len(e), sum(g) / len(g)
    log(f"{label} decode ms per step, 8 slots busy, same steps in turns "
        f"(eager, graph, graph, eager): eager {e}, graph {g}; mean eager "
        f"{eager_ms} ms, graph {graph_ms_} ms, eager / graph "
        f"{eager_ms / graph_ms_}")
    h = prof["host_split"]
    log(f"{label} host split of one eager decode step under the profiler: "
        f"wall {h['wall_ms']} ms; Python, model code and wrapper checks "
        f"{h['python_ms']} ms; aten dispatch outside runtime calls "
        f"{h['aten_ms']} ms ({h['aten_ops']} top-level aten ops); kernel "
        f"launch calls {h['launch_ms']} ms ({h['launch_calls']} calls); "
        f"other CUDA runtime calls {h['other_runtime_ms']} ms")
    for what, where in (("prefill", "B=8 prefill at rung 256"),
                        ("decode_eager", "eager decode step, 8 slots"),
                        ("decode", "graphed decode step, 8 slots")):
        p = prof[what]
        if p is None:
            log(f"{label} profiler, {where}: no device events in the trace "
                f"(not measured)")
            continue
        log(f"{label} profiler, {where}: {p['device_ops']} device ops "
            f"({p['kernels']} kernels), device busy {p['busy_ms']} ms")
    for what, wall in (("decode", run["decode_ms_per_step"]),
                       ("decode", graph_ms_), ("decode_eager", eager_ms),
                       ("prefill", rungs[256])):
        if prof[what] is not None:
            busy = prof[what]["busy_ms"]
            log(f"{label} {what}: device busy {busy} ms of {wall} ms "
                f"unprofiled, idle share {1 - busy / wall}")
    log(f"{label} streams, calibrated mode: {tokens}")
    log(f"{label} card vs CPU plain path: {parity}")


def phases(dev):
    """Every phase on ``dev``; returns the ``kernels`` list. Any failed check
    raises."""
    import torch
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.kernels import _build
    from repro_torch.models.api import build_model

    t0 = time.perf_counter()
    _build.build()
    log(f"build: CUDA kernels in {time.perf_counter() - t0:.1f} s")
    for src, text in sorted(_build.ptxas_log.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    t0 = time.perf_counter()
    cases = kernel_cases(dev)
    cases["ssd_scan"] = scan_cases(dev)
    log(f"kernels vs plain: {time.perf_counter() - t0:.1f} s")
    for kname, rows in cases.items():
        for r in rows:
            extra = (f" state_max_abs_err={r['state_max_abs_err']}"
                     if "state_max_abs_err" in r else "")
            log(f"  {kname} {r['case']}: max_abs_err={r['max_abs_err']}"
                f"{extra} ms={r['ms']} eager_ms={r['eager_ms']} "
                f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
                f"bound_ms={r['bound'][0]} ({r['bound'][1]})")
            if "geometry" in r:
                log(f"    launch: {r['geometry']}")
            if kname == "ssd_scan":
                log(f"    kernel / bound = {r['ms'] / r['bound'][0]}")
    for case, ms in decode_sweep(dev):
        log(f"  decode_attention geometry sweep {case}: ms={ms}")
    for kname in ("flash_attention", "decode_attention"):
        r = cases[kname][HEADLINE[kname]]
        ratio = (None if r["library_ms"] is None
                 else r["ms"] / r["library_ms"])
        log(f"{kname} at its headline shape ({r['case']}): kernel "
            f"{r['ms']} ms / library {r['library_ms']} ms = {ratio}")

    # the dense path: full-width smollm-360m
    t0 = time.perf_counter()
    cfg = ARCHITECTURES["smollm-360m"]
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers, "
        f"{sum(t.numel() for t in _leaves(params)) / 1e6:.1f} M params bf16")
    dense_kernels = ("rmsnorm", "decode_attention", "flash_attention")
    run = serve(model, params, dev, kernels=dense_kernels, max_len=256,
                max_prompt=200)
    rungs = prefill_rungs(model, params, dev, max_len=256)
    prof = device_profile(model, params, dev, max_len=256, max_prompt=200)
    timing = eager_vs_graph(model, params, dev, max_len=256, max_prompt=200)
    tokens = token_parity(model, params, dev, max_len=256, max_prompt=100,
                          reference=True)
    parity = cpu_parity(cfg, params, dev)
    report_path(cfg.name, run, rungs, prof, parity,
                per_prefill=("flash_attention",),
                per_step=("decode_attention",), timing=timing, tokens=tokens)
    log(f"{cfg.name} phases: {time.perf_counter() - t0:.1f} s")
    del model, params

    # the port's quickstart, as a user runs it on the card
    qrun = run_quickstart(dev)
    log(f"quickstart: {qrun['decode_steps']} decode steps in "
        f"{qrun['wall_s']:.3f} s; launches {qrun['launches']}")

    # the ssm path: full-width xlstm-125m; prefill runs an eager sLSTM time
    # loop (seconds at rung 512), so the prefill budget of AIMD admission
    # (slo * 0.5) is set above it
    t0 = time.perf_counter()
    xcfg = ARCHITECTURES["xlstm-125m"]
    xmodel = build_model(xcfg, device=dev)
    xparams = xmodel.init(torch.Generator(device=dev).manual_seed(0))
    log(f"model: {xcfg.name} full width, {xcfg.num_layers} layers "
        f"({xcfg.num_layers // 2} mLSTM/sLSTM pairs), "
        f"{sum(t.numel() for t in _leaves(xparams)) / 1e6:.1f} M params "
        f"(bf16, fp32 gates)")
    xrun = serve(xmodel, xparams, dev, kernels=("rmsnorm", "ssd_scan"),
                 max_len=512, max_prompt=480, slo=60.0)
    xrungs = prefill_rungs(xmodel, xparams, dev, max_len=512,
                           rungs=(8, 64, 256, 512))
    xprof = device_profile(xmodel, xparams, dev, max_len=512, max_prompt=480,
                           slo=60.0)
    xtiming = eager_vs_graph(xmodel, xparams, dev, max_len=512,
                             max_prompt=480, slo=60.0)
    xtokens = token_parity(xmodel, xparams, dev, max_len=512, max_prompt=100)
    xparity = cpu_parity(xcfg, xparams, dev, state=_xlstm_state)
    report_path(xcfg.name, xrun, xrungs, xprof, xparity,
                per_prefill=("ssd_scan",), per_step=(), timing=xtiming,
                tokens=xtokens)
    log(f"{xcfg.name} phases: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for kname, rows in cases.items():
        r = rows[HEADLINE[kname]]
        route, source = SOURCES[kname]
        by_path = {cfg.name: run["launches"][kname],
                   xcfg.name: xrun["launches"][kname],
                   "quickstart": qrun["launches"][kname]}
        kernels.append(dict(
            name=kname, route=route, source=source, replaces=REPLACES[kname],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            eager_ms=r["eager_ms"], case=r["case"],
            cases=[dict(case=c["case"], max_abs_err=c["max_abs_err"],
                        **{k: c[k] for k in ("state_max_abs_err", "geometry")
                           if k in c},
                        ms=c["ms"], eager_ms=c["eager_ms"],
                        plain_ms=c["plain_ms"],
                        bound_ms=c["bound"][0], bound_by=c["bound"][1],
                        library_ms=c["library_ms"]) for c in rows]))
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels = phases(torch.device("cuda"))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
