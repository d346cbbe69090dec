"""Plain PyTorch RMSNorm (the kernel's reference and its CPU path)."""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5,
                residual: Optional[torch.Tensor] = None):
    """Mean square in fp32, rsqrt, weight scale, cast back to ``x.dtype``
    (``repro.models.common.rmsnorm``).

    With ``residual``: returns ``(x + residual, rmsnorm(x + residual))``
    where the norm reads the fp32 sum before it is rounded to ``x.dtype``,
    as the reference's compiled residual-add-then-norm does."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
    return y if residual is None else (xf.to(x.dtype), y)
