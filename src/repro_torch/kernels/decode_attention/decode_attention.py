"""Binding of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py::
decode_attention``; the source's header says what bounds it on the H100 and
how its design answers that."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    lib = _build.load()
    fn = lib.decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
        fn.restype = _I
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     out: torch.Tensor, *, window: int, scale: float) -> None:
    """q, out: [B, Hq, D]; k/v_cache: [B, Smax, Hkv, D] (bf16, contiguous);
    lengths: [B] int32. Launches on the current stream."""
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), B, Smax, Hkv, Hq // Hkv,
                D, int(window), float(scale), stream)
    _build.check(err, "decode_attention")
