"""Checked chunked linear-attention scan (model layout ``[B, S, H, *]``).

CPU tensors take the plain version; CUDA tensors launch the CUDA kernel or
raise (bf16 q, k, v; fp32 gates and state; dk <= 512; chunk <= 1024).
``S % min(chunk, S) != 0`` raises on either device. ``ssd_scan_op.launches``
counts kernel launches."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import counted
from repro_torch.kernels.ssd_scan.ref import check_chunk, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import MAX_CHUNK, MAX_DK, ssd_scan


@counted
def ssd_scan_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, log_i: torch.Tensor, *,
                chunk: int = 256,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B, S, H, dk]; v: [B, S, H, dv]; log_f, log_i: [B, S, H];
    initial_state: [B, H, dk, dv] fp32 or None (zeros) -> (y [B, S, H, dv],
    final state [B, H, dk, dv] fp32), as ``repro.models.linear_core.
    chunked_linear_attention``."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4:
        raise ValueError(f"ssd_scan_op: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if (v.shape[:3] != q.shape[:3] or log_f.shape != (B, S, H)
            or log_i.shape != (B, S, H)):
        raise ValueError(f"ssd_scan_op: shapes v {tuple(v.shape)}, log_f "
                         f"{tuple(log_f.shape)}, log_i {tuple(log_i.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if initial_state is not None and initial_state.shape != (B, H, dk, dv):
        raise ValueError(f"ssd_scan_op: initial_state "
                         f"{tuple(initial_state.shape)} is not "
                         f"{(B, H, dk, dv)}")
    tensors = [q, k, v, log_f, log_i] + (
        [] if initial_state is None else [initial_state])
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("ssd_scan_op: inputs must be contiguous and on "
                             "one device")
    W = check_chunk(S, chunk)
    if q.device.type == "cpu":
        return ssd_scan_ref(q, k, v, log_f, log_i, chunk=chunk,
                            initial_state=initial_state)
    if q.device.type != "cuda":
        raise ValueError(f"ssd_scan_op: unsupported device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("ssd_scan_op: the kernel takes bf16 q, k, v")
    if any(t.dtype != torch.float32 for t in tensors[3:]):
        raise TypeError("ssd_scan_op: the kernel takes fp32 log_f, log_i "
                        "and initial_state")
    if dk > MAX_DK or W > MAX_CHUNK or dk < 1 or dv < 1:
        raise ValueError(f"ssd_scan_op: the kernel takes 1 <= dk <= {MAX_DK} "
                         f"and chunk <= {MAX_CHUNK}; got dk={dk} dv={dv} "
                         f"chunk={W}")
    y = torch.empty((B, S, H, dv), dtype=v.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    if B and H:
        ssd_scan(q, k, v, log_f, log_i, initial_state, y, state, chunk=W)
        ssd_scan_op.launches += 1
    return y, state
