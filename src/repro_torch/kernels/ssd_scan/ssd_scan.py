"""Binding of the CUDA chunked linear-attention scan (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan`` and adds
``initial_state`` and the model layout; the source's header says what
bounds it on the H100 and how its design answers that."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.load()
    fn = lib.ssd_scan_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        fn.restype = _I
    return fn


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_f: torch.Tensor, log_i: torch.Tensor,
             initial_state: Optional[torch.Tensor], y: torch.Tensor,
             state: torch.Tensor, *, chunk: int) -> None:
    """q, k: [B, S, H, dk], v, y: [B, S, H, dv] (bf16); log_f, log_i:
    [B, S, H], initial_state (or None: zeros), state: [B, H, dk, dv] (fp32);
    all contiguous, ``chunk`` divides S. Launches on the current stream."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                log_i.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                y.data_ptr(), state.data_ptr(), B, S, H, dk, dv, int(chunk),
                stream)
    _build.check(err, "ssd_scan")
