"""Checked prefill-attention entry point (model layout ``[B, S, H, D]``).

CPU tensors take the plain version; CUDA tensors launch the CUDA kernel or
raise (bf16, D in {16, 32, 64, 128}, 16-byte aligned; any Sq, Sk); meta
tensors get an empty output. ``flash_attention_op.launches`` counts kernel
launches; :func:`flash_attention_work` is a call's work."""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import Work, counted, refuse_autograd, softmax_scale
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_work(B: int, S: int, Hq: int, Hkv: int, D: int, *,
                         Sk: Optional[int] = None, causal: bool = True,
                         window: int = 0, q_offset: Optional[int] = None,
                         lengths: Optional[Sequence[int]] = None,
                         kv_valid: bool = False, itemsize: int = 2) -> Work:
    """The (row, key) pairs attended: causal (row r at absolute position
    ``q_offset + r``, default ``Sk - S``), within the window, below each
    sample's key length (``lengths``; None, shapes only: all ``Sk``),
    4 D bf16-input operations each (q k and p v). Bytes: q read and the
    output written for every row; the K and V rows some row attends
    (below each length; causal: from the first row's window start up to
    the last row's position, so a rank of a context-parallel prefill
    reads only the keys its rows see; a sample of length 0 reads V's
    ``Sk`` rows, as the plain path visits them); the lengths, where
    ``kv_valid`` is read."""
    Sk = Sk or S
    off = Sk - S if q_offset is None else q_offset
    lengths = [Sk] * B if lengths is None else lengths
    pairs = 0
    for n, times in Counter(lengths).items():
        if not causal:
            pairs += times * n * S
            continue
        pos = np.arange(S, dtype=np.int64) + off
        lo = np.maximum(0, pos - window + 1) if window else 0
        pairs += times * int(np.maximum(0, np.minimum(pos, n - 1) - lo
                                        + 1).sum())
    first = max(0, off - window + 1) if causal and window else 0
    last = off + S if causal else Sk      # one past the last key attended
    kv_rows = sum(2 * max(0, min(n, last) - first) if n else Sk
                  for n in lengths)
    nbytes = (2 * B * S * Hq * D * itemsize + kv_rows * Hkv * D * itemsize
              + (B * 4 if kv_valid else 0))
    return Work(nbytes, {"bf16": 4 * D * pairs * Hq})


def _call_work(q, k, v, *, causal=True, window=0, q_block=512, k_block=1024,
               scale=None, q_offset=None, kv_valid=None) -> Work:
    B, S, Hq, D = q.shape
    return flash_attention_work(B, S, Hq, k.shape[2], D, Sk=k.shape[1],
                                causal=causal, window=window,
                                q_offset=q_offset,
                                kv_valid=kv_valid is not None,
                                itemsize=q.element_size())


@counted("flash_attention", _call_work)
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
    if q.device.type == "meta":
        return torch.empty_like(q)
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
