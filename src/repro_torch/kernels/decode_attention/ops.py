"""Checked decode-attention entry point (model layout).

CPU tensors take the plain version; CUDA tensors launch the CUDA kernel or
raise (any Smax, G <= 8, even D <= 128, bf16). ``decode_attention_op.
launches`` counts kernel launches."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import counted, softmax_scale
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


@counted
def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, lengths: torch.Tensor, *,
                        window: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, 1, Hq, D]; k/v_cache: [B, Smax, Hkv, D]; lengths: [B] ->
    [B, 1, Hq, D] (as ``repro.models.common.attention_decode``)."""
    B, one, Hq, D = q.shape
    if (k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[0] != B or k_cache.shape[3] != D or one != 1):
        raise ValueError(f"decode_attention_op: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    Hkv = k_cache.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention_op: Hq={Hq} is not a multiple "
                         f"of Hkv={Hkv}")
    for t in (q, k_cache, v_cache, lengths):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention_op: q, k, v, lengths must be "
                             "contiguous and on one device")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise TypeError("decode_attention_op: lengths must be [B] int32")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_op: unsupported device {q.device}")
    if Hq // Hkv > 8 or D % 2 or D > 128:
        raise ValueError(f"decode_attention_op: the kernel takes G <= 8 and "
                         f"even D <= 128; got G={Hq // Hkv} D={D}")
    if any(t.dtype != torch.bfloat16 for t in (q, k_cache, v_cache)):
        raise TypeError("decode_attention_op: the kernel takes bf16 q, k, v")
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention)

    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if B:
        decode_attention(q.view(B, Hq, D), k_cache, v_cache, lengths, out,
                         window=window, scale=softmax_scale(scale, D))
        decode_attention_op.launches += 1
    return out.view(B, 1, Hq, D)
