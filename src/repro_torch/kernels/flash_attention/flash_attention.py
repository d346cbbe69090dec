"""Binding of the CUDA prefill-attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention`` and adds ``kv_valid`` and ``q_offset``; the source's header
says what bounds it on the H100 and how its design answers that. The launch
geometry is computed here (:func:`geometry`), where the CPU tests reach it,
and passed to the kernel, which refuses any other."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

M_TILE = 64      # (query row, head in group) pairs per block
K_TILE = 64      # keys per shared-memory tile
SMEM_PAD = 8     # bf16 of padding per shared-memory row
NO_WINDOW = 1 << 30


class Geometry(NamedTuple):
    m_tiles: int      # blocks per (kv head, sample)
    blocks: int       # the whole grid: m_tiles * Hkv * B
    smem_bytes: int   # dynamic shared memory: the q tile, K and V twice each


def geometry(B: int, Sq: int, Hq: int, Hkv: int, D: int) -> Geometry:
    """The launch of a [B, Sq, Hq, D] prefill against Hkv kv heads: M tiles
    of ``M_TILE`` flattened (query row, head in group) pairs."""
    m_tiles = -(-Sq * (Hq // Hkv) // M_TILE)
    smem = (M_TILE + 4 * K_TILE) * (D + SMEM_PAD) * 2
    return Geometry(m_tiles, m_tiles * Hkv * B, smem)


def tile_pairs(tile: int, Sq: int, G: int) -> list:
    """The (query row, head in group) pairs of M tile ``tile``, as the kernel
    flattens them: M-row m is row m // G, head m % G."""
    return [divmod(m, G)
            for m in range(tile * M_TILE, min((tile + 1) * M_TILE, Sq * G))]


def tile_key_range(tile: int, Sq: int, G: int, Sk: int, kv_valid: int, *,
                   q_offset: int, window: int, causal: bool) -> tuple:
    """[start, end) of the keys M tile ``tile`` loads: from the window start
    of its first row to the causal diagonal of its last row and to
    ``kv_valid``. Empty (end <= start) where no row of the tile has a key."""
    w = window if window > 0 else NO_WINDOW
    rows = [r for r, _ in tile_pairs(tile, Sq, G)]
    start = max(0, q_offset + rows[0] - w + 1)
    end = max(0, min(kv_valid, Sk))
    if causal:
        end = min(end, q_offset + rows[-1] + 1)
    return start, end


def _fn():
    lib = _build.load()
    fn = lib.flash_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P] + [_I] * 11 + [ctypes.c_float,
                                                          _I, _I, _P]
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
    geo = geometry(B, Sq, Hq, Hkv, D)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if kv_valid is None else kv_valid.data_ptr(),
                out.data_ptr(), B, Sq, Sk, Hq, Hkv, D, int(causal),
                int(window), int(q_offset), int(q_block), int(k_block),
                float(scale), geo.m_tiles, geo.smem_bytes, stream)
    _build.check(err, "flash_attention")
