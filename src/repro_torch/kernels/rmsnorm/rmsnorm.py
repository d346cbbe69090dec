"""Triton RMSNorm for Hopper.

Replaces: ``src/repro/kernels/rmsnorm/rmsnorm.py::rmsnorm`` (Pallas TPU,
``[row_blk, d]`` tiles, fp32 statistics in one VMEM pass).

Why Triton and not CUDA: the work is a row reduction plus an elementwise
scale, with no tensor-core product and no shared-memory staging to schedule;
Triton's masked block loads and ``tl.sum`` express it fully and compile to
the same coalesced loads a CUDA version would issue.

What bounds it on the H100: bytes. It reads ``x`` (and the residual) and
``w`` once and writes ``y`` (and the sum) once, about 2 * N * d * 2 bytes
(4 * N * d * 2 with the residual) in bf16, for ~4 flops an element.

Design: one program per row, the whole row in one ``BLOCK_D =
next_pow2(d)`` block (1024 lanes for d = 960, the tail masked), so ``x`` is
read once and kept in registers between the mean square and the scale; no
row-count divisibility is needed (the Pallas wrapper halves its row block
until it divides N). With a ``residual`` the program first adds it to the
row and writes the rounded sum, then normalises the fp32 sum: the
residual add before a layer's second norm done in the same pass, rounded as
the reference's compiled add-then-norm rounds it. ``triton`` is imported on
the first launch, so the module imports where Triton is not installed."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import triton_cache_dir

_kernel = None


def _get_kernel():
    global _kernel
    if _kernel is None:
        triton_cache_dir()
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_kernel(x_ptr, r_ptr, w_ptr, y_ptr, s_ptr, d, eps,
                           HAS_RESIDUAL: tl.constexpr, BLOCK_D: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < d
            x = tl.load(x_ptr + row * d + cols, mask=mask,
                        other=0.0).to(tl.float32)
            if HAS_RESIDUAL:
                x += tl.load(r_ptr + row * d + cols, mask=mask,
                             other=0.0).to(tl.float32)
                tl.store(s_ptr + row * d + cols,
                         x.to(s_ptr.dtype.element_ty), mask=mask)
            var = tl.sum(x * x, axis=0) / d
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = x * tl.rsqrt(var + eps) * w
            tl.store(y_ptr + row * d + cols,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        _kernel = rmsnorm_kernel
    return _kernel


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def rmsnorm(x2: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
            eps: float, residual: Optional[torch.Tensor] = None,
            out_sum: Optional[torch.Tensor] = None) -> None:
    """x2, out (and residual, out_sum): [N, d] contiguous on one CUDA
    device; w: [d]. Writes ``out`` (and ``out_sum = x2 + residual``, the norm
    then reading the fp32 sum). Launches on the current stream."""
    n, d = x2.shape
    block = next_pow2(d)
    has_res = residual is not None
    _get_kernel()[(n,)](x2, residual if has_res else x2, w, out,
                        out_sum if has_res else out, d, eps,
                        HAS_RESIDUAL=has_res, BLOCK_D=block,
                        num_warps=4 if block <= 2048 else 8)
