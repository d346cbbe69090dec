"""Binding of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py::
decode_attention``; the source's header says what bounds it on the H100 and
how its design answers that. The launch geometry is chosen here, where the
CPU tests reach it: the cluster size, blocks per (kv head, sample)
(:func:`cluster_size`), and the warps per block (:func:`block_warps`);
:func:`cluster_slices` states how the kernel splits a sample's positions
among the blocks of a cluster."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_CLUSTER = 8       # the portable thread-block cluster size
BLOCK_G = 8           # the most query heads one block takes
SMS = 132             # streaming multiprocessors of an H100 SXM
MIN_SLICE = 16        # fewest positions worth a block of their own
ROWS_PER_WARP = 16    # positions a warp reads per step at D <= 64, G <= 4


def head_groups(G: int) -> int:
    """The groups the ``G`` query heads of a kv head are cut into, one grid
    row each: ``ceil(G / BLOCK_G)``, of ``ceil(G / groups)`` heads but the
    last (G = 13: 7 and 6), so that no block holds the registers of more
    than ``BLOCK_G`` heads. 1 where G <= 8."""
    return -(-G // BLOCK_G)


def cluster_size(B: int, Hkv: int, Smax: int, window: int) -> int:
    """Blocks per (kv head, sample): the smallest power of two that puts two
    blocks on each SM, at most ``MAX_CLUSTER`` and at most one block per
    ``MIN_SLICE`` positions of the longest range a sample can have.
    ``Hkv`` counts the grid's rows: kv heads times their head groups."""
    span = min(Smax, window) if window > 0 else Smax
    c = 1
    while (c < MAX_CLUSTER and c * B * Hkv < 2 * SMS
           and MIN_SLICE * c < span):
        c *= 2
    return c


def block_warps(Smax: int, window: int, c: int) -> int:
    """Warps per block: two, or four where a block's slice of the longest
    range a sample can have takes a two-warp block more than two steps.
    Fewer threads make the cluster's launch and barriers cheaper; more keep
    more rows in flight on a long slice."""
    span = min(Smax, window) if window > 0 else Smax
    return 4 if -(-span // c) > 4 * ROWS_PER_WARP else 2


def cluster_slices(length: int, Smax: int, window: int, c: int) -> list:
    """[start, end) of the positions each of the ``c`` blocks of a cluster
    reads for a sample of ``length`` valid positions: even slices of
    [max(0, length - window), min(length, Smax)), as the kernel cuts them."""
    hi = min(length, Smax)
    lo = max(0, length - window) if window > 0 else 0
    per = -(-max(0, hi - lo) // c)
    return [(lo + r * per, max(lo + r * per, min(lo + (r + 1) * per, hi)))
            for r in range(c)]


def _fn():
    lib = _build.load()
    fn = lib.decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _I, _P]
        fn.restype = _I
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     out: torch.Tensor, *, window: int, scale: float) -> None:
    """q, out: [B, Hq, D]; k/v_cache: [B, Smax, Hkv, D] (bf16, contiguous);
    lengths: [B] int32. Launches on the current stream."""
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    c = cluster_size(B, Hkv * head_groups(Hq // Hkv), Smax, window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), B, Smax, Hkv, Hq // Hkv,
                D, int(window), float(scale), c,
                block_warps(Smax, window, c), stream)
    _build.check(err, "decode_attention")
