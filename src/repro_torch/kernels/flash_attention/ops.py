"""Checked prefill-attention entry point (model layout ``[B, S, H, D]``).

CPU tensors take the plain version; CUDA tensors launch the CUDA kernel or
raise (bf16, D in {16, 32, 64, 128}, 16-byte aligned; any Sq, Sk).
``flash_attention_op.launches`` counts kernel launches."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import counted, refuse_autograd, softmax_scale
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_HEAD_DIMS = (16, 32, 64, 128)


@counted
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       q_block: int = 512, k_block: int = 1024,
                       scale: Optional[float] = None,
                       q_offset: Optional[int] = None,
                       kv_valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; kv_valid: [B] per-sample key
    length or None; q_offset: absolute position of q row 0 (default
    ``Sk - Sq``) -> [B, Sq, Hq, D] (as ``repro.models.common.
    attention_prefill``)."""
    B, Sq, Hq, D = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != D):
        raise ValueError(f"flash_attention_op: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_op: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    for t in (q, k, v) + (() if kv_valid is None else (kv_valid,)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention_op: q, k, v, kv_valid must be "
                             "contiguous and on one device")
    if kv_valid is not None and (kv_valid.shape != (B,)
                                 or kv_valid.dtype != torch.int32):
        raise TypeError("flash_attention_op: kv_valid must be [B] int32")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_block=q_block, k_block=k_block,
                                   scale=scale, q_offset=q_offset,
                                   kv_valid=kv_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_op: unsupported device {q.device}")
    refuse_autograd("flash_attention_op", q, k, v)
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_op: the kernel takes D in "
                         f"{_HEAD_DIMS}; got D={D}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("flash_attention_op: the kernel takes bf16 q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_op: the kernel reads q, k, v in "
                         "16-byte vectors; their storage must be 16-byte "
                         "aligned")
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention)

    out = torch.empty_like(q)
    if B and Sq:
        flash_attention(q, k, v, kv_valid, out, causal=causal, window=window,
                        q_offset=Sk - Sq if q_offset is None else q_offset,
                        q_block=q_block, k_block=k_block,
                        scale=softmax_scale(scale, D))
        flash_attention_op.launches += 1
    return out
