"""What one kernel call must do, frozen for the benchmark.

Copied at commit 1c513d0 from ``src/repro_torch/kernels/__init__.py``
(``Work``) and the four ``ops.py`` files under ``src/repro_torch/kernels/``
(``decode_attention_work``, ``flash_attention_work``, ``rmsnorm_work``,
``ssd_scan_work``), unchanged. A later change to the program may change its
own copies; the benchmark reads these. ``ssd_scan_valid_work`` is the
benchmark's own: ``ssd_scan_work`` summed over samples of their valid
lengths, the last chunk of each partial."""

from __future__ import annotations

from collections import Counter
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np


class Work(NamedTuple):
    """What one kernel call must do: the bytes it must move (each input
    read once, each output written once) and its operations by the dtype
    whose peak rate they run at (``"bf16"``: tensor cores; ``"f32"``)."""

    bytes: float
    flops: Dict[str, float]


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


def rmsnorm_work(n: int, d: int, *, residual: bool = False,
                 itemsize: int = 2) -> Work:
    """N rows of d: x and the weight read, the output written (with the
    residual: it is read and the sum written too); the fp32 square, sum,
    scale and weight, 4 operations an element."""
    nbytes = (2 * n * d + d) * itemsize * (2 if residual else 1)
    return Work(nbytes, {"f32": 4 * n * d})


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


def ssd_scan_valid_work(lengths: Sequence[int], H: int, dk: int, dv: int, *,
                        chunk: int, state_in: bool,
                        itemsize: int = 2) -> Work:
    """``ssd_scan_work``'s count for samples of ``lengths`` valid positions
    each, every sample alone: its full chunks of ``chunk`` and its partial
    last one, its state written (and read where one is given) once."""
    nbytes, bf16, f32 = 0.0, 0.0, 0.0
    for n in lengths:
        full, rest = divmod(int(n), chunk)
        causal = full * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2
        nbytes += ((2 * n * H * dk + 2 * n * H * dv) * itemsize
                   + 2 * n * H * 4 + H * dk * dv * 4 * (2 if state_in else 1))
        bf16 += 2 * H * causal * dk
        f32 += 2 * H * (causal * dv + 2 * n * dk * dv)
    return Work(nbytes, {"bf16": bf16, "f32": f32})
