"""Checked chunked linear-attention scan (model layout ``[B, S, H, *]``).

CPU tensors take the plain version; CUDA tensors launch the CUDA kernel or
raise (bf16 q, k, v; fp32 gates and state; dk <= 512; chunk <= 1024); meta
tensors get empty outputs. ``S % min(chunk, S) != 0`` raises on every
device. ``ssd_scan_op.launches`` counts kernel launches;
:func:`ssd_scan_work` is a call's work."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import Work, counted, refuse_autograd
from repro_torch.kernels.ssd_scan.ref import check_chunk, ssd_scan_ref
from repro_torch.kernels.ssd_scan.ssd_scan import MAX_CHUNK, MAX_DK, ssd_scan


def ssd_scan_work(B: int, S: int, H: int, dk: int, dv: int, *, chunk: int,
                  state_in: bool, itemsize: int = 2) -> Work:
    """q, k, v read and y written, the two fp32 gates read, the fp32 state
    written (and read where one is given); per chunk of ``W = min(chunk,
    S)`` the causal half of q k^T (bf16 inputs, fp32 sums: the tensor
    cores' rate), and in fp32 the causal half of P v and per step the state
    read (q . S) and update (k^T v)."""
    W = min(chunk, S)
    nbytes = ((2 * B * S * H * dk + 2 * B * S * H * dv) * itemsize
              + 2 * B * S * H * 4 + B * H * dk * dv * 4 * (2 if state_in
                                                             else 1))
    causal = (S // W) * W * (W + 1) // 2
    return Work(nbytes, {"bf16": 2 * B * H * causal * dk,
                         "f32": 2 * B * H * (causal * dv + 2 * S * dk * dv)})


def _call_work(q, k, v, log_f, log_i, *, chunk=256,
               initial_state=None) -> Work:
    B, S, H, dk = q.shape
    return ssd_scan_work(B, S, H, dk, v.shape[-1], chunk=chunk,
                         state_in=initial_state is not None,
                         itemsize=q.element_size())


@counted("ssd_scan", _call_work)
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
    if q.device.type == "meta":
        return (torch.empty((B, S, H, dv), dtype=v.dtype, device=q.device),
                torch.empty((B, H, dk, dv), dtype=torch.float32,
                            device=q.device))
    if q.device.type != "cuda":
        raise ValueError(f"ssd_scan_op: unsupported device {q.device}")
    refuse_autograd("ssd_scan_op", *tensors)
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
