"""Checked RMSNorm entry point (any leading dims), optionally with the
residual add fused in front.

CPU tensors take the plain version; CUDA tensors launch the CUDA kernel
or raise (it takes bf16 x and weight, d up to 16,384); meta tensors get
empty outputs. ``rmsnorm_op.launches`` counts kernel launches;
:func:`rmsnorm_work` is a call's work."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import Work, counted, refuse_autograd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm


def rmsnorm_work(n: int, d: int, *, residual: bool = False,
                 itemsize: int = 2) -> Work:
    """N rows of d: x and the weight read, the output written (with the
    residual: it is read and the sum written too); the fp32 square, sum,
    scale and weight, 4 operations an element."""
    nbytes = (2 * n * d + d) * itemsize * (2 if residual else 1)
    return Work(nbytes, {"f32": 4 * n * d})


def _call_work(x, w, *, eps=1e-5, residual=None) -> Work:
    return rmsnorm_work(x.numel() // x.shape[-1], x.shape[-1],
                        residual=residual is not None,
                        itemsize=x.element_size())


@counted("rmsnorm", _call_work)
def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
               residual: Optional[torch.Tensor] = None):
    """x: [..., d]; w: [d] -> [..., d] in ``x.dtype``. With ``residual``
    (shaped like ``x``): returns ``(x + residual, rmsnorm(x + residual))``,
    the norm reading the sum before it is rounded."""
    d = x.shape[-1]
    dev = x.device
    if w.device != dev or w.shape != (d,):
        raise ValueError(f"rmsnorm_op: weight {tuple(w.shape)} on {w.device} "
                         f"does not match x [..., {d}] on {dev}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_op: x and w must be contiguous")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != dev or not residual.is_contiguous()):
        raise ValueError("rmsnorm_op: residual must be a contiguous tensor "
                         "shaped, typed and placed like x")
    kind = dev.type
    if kind == "cpu":
        return rmsnorm_ref(x, w, eps=eps, residual=residual)
    if kind == "meta":
        out = torch.empty_like(x)
        return out if residual is None else (torch.empty_like(x), out)
    if kind != "cuda":
        raise ValueError(f"rmsnorm_op: unsupported device {dev}")
    refuse_autograd("rmsnorm_op", x, w, residual)
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"rmsnorm_op: the kernel takes bf16 x and weight; "
                        f"got {x.dtype}, {w.dtype}")
    out = torch.empty_like(x)
    out_sum = None if residual is None else torch.empty_like(x)
    if x.numel():
        rmsnorm(x, w, out, eps, residual, out_sum)
        rmsnorm_op.launches += 1
    return out if residual is None else (out_sum, out)
