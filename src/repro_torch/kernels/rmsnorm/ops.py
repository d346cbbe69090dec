"""Checked RMSNorm entry point (any leading dims), optionally with the
residual add fused in front.

CPU tensors take the plain version; CUDA tensors launch the Triton kernel
or raise. ``rmsnorm_op.launches`` counts kernel launches."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import counted
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


@counted
def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
               residual: Optional[torch.Tensor] = None):
    """x: [..., d]; w: [d] -> [..., d] in ``x.dtype``. With ``residual``
    (shaped like ``x``): returns ``(x + residual, rmsnorm(x + residual))``,
    the norm reading the sum before it is rounded."""
    d = x.shape[-1]
    if w.device != x.device or w.shape != (d,):
        raise ValueError(f"rmsnorm_op: weight {tuple(w.shape)} on {w.device} "
                         f"does not match x [..., {d}] on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_op: x and w must be contiguous")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device or not residual.is_contiguous()):
        raise ValueError("rmsnorm_op: residual must be a contiguous tensor "
                         "shaped, typed and placed like x")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_op: unsupported device {x.device}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm_op: dtypes {x.dtype}, {w.dtype}")
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm

    x2 = x.view(-1, d)
    out = torch.empty_like(x2)
    out_sum = None if residual is None else torch.empty_like(x2)
    if x2.shape[0]:
        rmsnorm(x2, w, out, eps,
                None if residual is None else residual.view(-1, d), out_sum)
        rmsnorm_op.launches += 1
    if residual is None:
        return out.view(x.shape)
    return out_sum.view(x.shape), out.view(x.shape)
