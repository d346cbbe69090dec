"""Checked decode-attention entry point (model layout).

CPU tensors take the plain version; CUDA tensors launch the CUDA kernel or
raise (any Smax, G <= 16, even D <= 128, bf16, K and V 4-byte aligned);
meta tensors get an empty output. ``decode_attention_op.launches`` counts
the calls that launched the kernel, one each; a call makes one CUDA launch,
or two where a span (Smax, or the window) past 32,768 positions is merged
through a workspace, and ``decode_attention_op.cuda_launches`` adds those up where
the call launches (unlike ``launches``, it is not moved from a graph's
capture to its replays: read it over eager calls).
:func:`decode_attention_work` is a call's work."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import Work, counted, refuse_autograd, softmax_scale
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

MAX_G = 16      # query heads a kv head the kernel takes


def decode_attention_work(B: int, Hq: int, Hkv: int, D: int, Smax: int, *,
                          window: int = 0,
                          lengths: Optional[Sequence[int]] = None,
                          itemsize: int = 2) -> Work:
    """q read and the output written, the lengths read, and the K and V
    rows each sample attends, ``[max(0, len - window), min(len, Smax))``;
    the q k and p v products (bf16 inputs). ``lengths`` None (shapes only,
    as a wrapper call records it): every sample attends a full cache."""
    lengths = [Smax] * B if lengths is None else lengths
    used = sum(min(n, Smax) - (max(0, n - window) if window else 0)
               for n in lengths)
    nbytes = 2 * B * Hq * D * itemsize + B * 4 + 2 * used * Hkv * D * itemsize
    return Work(nbytes, {"bf16": 4 * Hq * D * used})


def _call_work(q, k_cache, v_cache, lengths, *, window=0,
               scale=None) -> Work:
    B, _, Hq, D = q.shape
    return decode_attention_work(B, Hq, k_cache.shape[2], D,
                                 k_cache.shape[1], window=window,
                                 itemsize=q.element_size())


@counted("decode_attention", _call_work)
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
    if q.device.type == "meta":
        return torch.empty(q.shape, dtype=v_cache.dtype, device=q.device)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_op: unsupported device {q.device}")
    refuse_autograd("decode_attention_op", q, k_cache, v_cache)
    if Hq // Hkv > MAX_G or D % 2 or D > 128:
        raise ValueError(f"decode_attention_op: the kernel takes G <= "
                         f"{MAX_G} and even D <= 128; got G={Hq // Hkv} "
                         f"D={D}")
    if any(t.dtype != torch.bfloat16 for t in (q, k_cache, v_cache)):
        raise TypeError("decode_attention_op: the kernel takes bf16 q, k, v")
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention)

    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    if B:
        decode_attention_op.cuda_launches += decode_attention(
            q.view(B, Hq, D), k_cache, v_cache, lengths, out, window=window,
            scale=softmax_scale(scale, D))
        decode_attention_op.launches += 1
    return out.view(B, 1, Hq, D)


decode_attention_op.cuda_launches = 0
