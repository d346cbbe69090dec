"""Binding of the CUDA prefill-attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention`` and adds ``kv_valid`` and ``q_offset``; the source's header
says what bounds it on the H100 and how its design answers that."""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.load()
    fn = lib.flash_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P] + [_I] * 11 + [ctypes.c_float, _P]
        fn.restype = _I
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor], out: torch.Tensor, *,
                    causal: bool, window: int, q_offset: int, q_block: int,
                    k_block: int, scale: float) -> None:
    """q, out: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D] (bf16, contiguous, model
    layout); kv_valid: [B] int32 or None. ``q_block`` / ``k_block`` are the
    plain version's block sizes, which fix what a row without any valid key
    outputs. Launches on the current stream."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if kv_valid is None else kv_valid.data_ptr(),
                out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal),
                int(window), int(q_offset), int(q_block), int(k_block),
                float(scale), stream)
    _build.check(err, "flash_attention")
