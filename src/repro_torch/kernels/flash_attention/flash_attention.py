"""Binding of the CUDA prefill-attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/flash_attention.py::
flash_attention`` and adds ``kv_valid`` and ``q_offset``; the source's header
says what bounds it on the H100 and how its two instances answer that. The
launch geometry is computed here (:func:`geometry`: the instance, from static
shapes alone, and its tiles, grid and shared memory), where the CPU tests
reach it, and passed to the kernel, which refuses any other. So are the
launch order of the wgmma instance's blocks (:func:`schedule`) and the class
of each key tile a block loads (:func:`key_tiles`)."""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

MMA, WGMMA = "mma", "wgmma"
INSTANCES = (MMA, WGMMA)   # the C entry point's instance numbers
M_TILE = {MMA: 64, WGMMA: 128}   # (query row, head in group) pairs a block
GROUP_ROWS = 64  # M-rows a warp group owns (wgmma: two consumer groups)
STAGES = 4       # the wgmma instance's ring of K and V tiles
SMEM_PAD = 8     # bf16 of padding per shared-memory row
NO_WINDOW = 1 << 30
SMS = 132             # H100 SXM streaming multiprocessors
L2_BYTES = 50 << 20   # H100 L2 cache


class Geometry(NamedTuple):
    instance: str     # MMA or WGMMA
    m_tile: int       # M-rows a work item
    k_tile: int       # keys a shared-memory tile
    m_tiles: int      # work items per (kv head, sample)
    items: int        # (M tile, kv head, sample) work items: m_tiles * Hkv * B
    blocks: int       # the grid: mma one block an item; wgmma a persistent
                      # block an SM, at most one an item
    group: int        # wgmma: samples a group of the work list
    threads: int
    stages: int       # K / V tiles in flight
    smem_bytes: int   # dynamic shared memory


def k_tile(instance: str, D: int) -> int:
    """Keys a tile: the mma instance 64; wgmma 128, 64 at D = 128 (whose
    O accumulator takes 64 registers a thread)."""
    return 64 if instance == MMA or D == 128 else 128


def smem_bytes(instance: str, D: int) -> int:
    """mma: the q tile and two K and two V tiles, rows of D + 8 bf16.
    wgmma: ``STAGES`` K and V tiles (TMA's swizzled rows, no padding), two
    q tiles of each consumer group (the next work item's lands while this
    one runs), a full and an empty barrier a stage, and 1024 bytes to align
    the ring to the 128-byte swizzle's period."""
    if instance == MMA:
        return (M_TILE[MMA] + 4 * 64) * (D + SMEM_PAD) * 2
    tile = k_tile(WGMMA, D) * D * 2
    return (1024 + STAGES * 2 * tile + 2 * M_TILE[WGMMA] * (D + SMEM_PAD) * 2
            + 2 * STAGES * 8)


def pick(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
         causal: bool) -> str:
    """The instance for a call's static shapes (never its data): the wgmma
    instance, but where every key fits one of its key tiles (Sk <= 128),
    so that it has nothing to pipeline; there the mma instance's twice as
    many 64-row blocks of 128 threads spread the same work over more SMs
    and start sooner (on the H100, ``scripts/flash_checkouts.py
    --instances``: every rung-128 row of PERF.md's table ran 12-23 %
    faster on it)."""
    return MMA if Sk <= 128 else WGMMA


def geometry(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
             causal: bool = True, instance: Optional[str] = None) -> Geometry:
    """The launch of a [B, Sq, Hq, D] prefill against Sk keys of Hkv kv
    heads: M tiles of flattened (query row, head in group) pairs, on the
    instance :func:`pick` chooses (or ``instance``, to measure one)."""
    inst = instance or pick(B, Sq, Sk, Hq, Hkv, D, causal)
    m_tiles = -(-Sq * (Hq // Hkv) // M_TILE[inst])
    items = m_tiles * Hkv * B
    # the samples whose K and V fit half of L2 together
    group = max(1, min(B, L2_BYTES // 2 // max(1, 4 * Sk * Hkv * D)))
    return Geometry(inst, M_TILE[inst], k_tile(inst, D), m_tiles, items,
                    items if inst == MMA else min(items, SMS), group,
                    128 if inst == MMA else 384,
                    2 if inst == MMA else STAGES, smem_bytes(inst, D))


def schedule(geo: Geometry, Hkv: int, B: int, causal: bool) -> List[tuple]:
    """(M tile, kv head, sample) of each work item in launch order. wgmma:
    in groups of ``geo.group`` samples (whose K and V fit half of L2, so
    that the blocks running together read them from L2), in each group a
    causal call's M tiles in descending order, so that the longest key
    ranges start first, every (kv head, sample) of a tile before the next
    tile; the persistent blocks take them in rounds of ``blocks``, forwards
    and backwards in turn (:func:`block_items`). mma: the grid (M tile, kv
    head, sample), M tile fastest, one block an item."""
    if geo.instance == MMA:
        return [(t, h, b) for b in range(B) for h in range(Hkv)
                for t in range(geo.m_tiles)]
    order = []
    for g0 in range(0, B, geo.group):
        samples = min(geo.group, B - g0)
        for t in range(geo.m_tiles):
            for pair in range(samples * Hkv):
                order.append((geo.m_tiles - 1 - t if causal else t,
                              pair % Hkv, g0 + pair // Hkv))
    return order


def block_items(geo: Geometry, j: int) -> List[int]:
    """The indices into :func:`schedule` that block ``j`` runs, in order:
    round r's item is r * blocks + j, or r * blocks + blocks - 1 - j in the
    odd rounds, so that the blocks' shares of a longest-first list stay
    even (``nth_item`` in the source)."""
    g = geo.blocks
    out = []
    for r in range(-(-geo.items // g)):
        i = r * g + (g - 1 - j if r % 2 else j)
        if i < geo.items:
            out.append(i)
    return out


def tile_pairs(tile: int, Sq: int, G: int, m_tile: int) -> list:
    """The (query row, head in group) pairs of M tile ``tile``, as the kernel
    flattens them: M-row m is row m // G, head m % G."""
    return [divmod(m, G)
            for m in range(tile * m_tile, min((tile + 1) * m_tile, Sq * G))]


def _limits(row: int, q_offset: int, window: int, causal: bool,
            kv_valid: int) -> Tuple[int, int]:
    """[klo, khi) of the keys query row ``row`` attends."""
    w = window if window > 0 else NO_WINDOW
    qpos = q_offset + row
    return qpos - w + 1, min(kv_valid, qpos + 1) if causal else kv_valid


def tile_key_range(tile: int, Sq: int, G: int, Sk: int, kv_valid: int, *,
                   q_offset: int, window: int, causal: bool,
                   m_tile: int) -> tuple:
    """[start, end) of the keys M tile ``tile`` loads: from the window start
    of its first row to the causal diagonal of its last row and to
    ``kv_valid``. Empty (end <= start) where no row of the tile has a key."""
    rows = [r for r, _ in tile_pairs(tile, Sq, G, m_tile)]
    start = max(0, _limits(rows[0], q_offset, window, causal, Sk)[0])
    end = max(0, min(kv_valid, Sk))
    if causal:
        end = min(end, q_offset + rows[-1] + 1)
    return start, end


def key_tiles(geo: Geometry, tile: int, Sq: int, G: int, Sk: int,
              kv_valid: int, *, q_offset: int, window: int,
              causal: bool) -> List[tuple]:
    """(t0, classes) of each key tile [t0, t0 + k_tile) M tile ``tile``
    loads, from its range's start; ``classes`` holds, for each warp group
    of ``GROUP_ROWS`` M-rows, "free" where the tile lies inside every valid
    row's key range of the group (the kernel skips the per-score mask) and
    "masked" where it does not (the mma instance masks every tile). Keys
    outside the loaded tiles are not loaded."""
    start, end = tile_key_range(tile, Sq, G, Sk, kv_valid, q_offset=q_offset,
                                window=window, causal=causal,
                                m_tile=geo.m_tile)
    kvv = max(0, min(kv_valid, Sk))
    groups = []
    for g0 in range(tile * geo.m_tile, (tile + 1) * geo.m_tile, GROUP_ROWS):
        if geo.instance == MMA or g0 >= Sq * G:
            groups.append(None)
            continue
        lo_row, hi_row = g0 // G, (min(g0 + GROUP_ROWS, Sq * G) - 1) // G
        free_from = _limits(hi_row, q_offset, window, causal, kvv)[0]
        free_to = _limits(lo_row, q_offset, window, causal, kvv)[1]
        groups.append((free_from, free_to))
    out = []
    for t0 in range(start, end, geo.k_tile):
        out.append((t0, tuple(
            "free" if g and t0 >= g[0] and t0 + geo.k_tile <= g[1]
            else "masked" for g in groups)))
    return out


def _lib():
    lib = _build.load()
    fn = lib.flash_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P] + [_I] * 11 + [ctypes.c_float,
                                                          _I, _I, _I, _I, _I,
                                                          _P]
        fn.restype = _I
        enc = lib.flash_attention_encode
        enc.argtypes = [_P, _P] + [_I] * 5
        enc.restype = _I
    return lib


def encode_maps(k: torch.Tensor, v: torch.Tensor, reps: int) -> None:
    """Encode the wgmma instance's two TMA tensor maps of ``k`` and ``v``
    ``reps`` times on the host, launching nothing (to time the encode)."""
    B, Sk, Hkv, D = k.shape
    _build.check(_lib().flash_attention_encode(
        k.data_ptr(), v.data_ptr(), B, Sk, Hkv, D, reps),
        "flash_attention_encode")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_valid: Optional[torch.Tensor], out: torch.Tensor, *,
                    causal: bool, window: int, q_offset: int, q_block: int,
                    k_block: int, scale: float,
                    instance: Optional[str] = None) -> None:
    """q, out: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D] (bf16, contiguous, model
    layout); kv_valid: [B] int32 or None. ``q_block`` / ``k_block`` are the
    plain version's block sizes, which fix what a row without any valid key
    outputs. ``instance`` forces one (to measure it); None: :func:`pick`.
    Launches on the current stream."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    geo = geometry(B, Sq, Sk, Hq, Hkv, D, causal, instance)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if kv_valid is None else kv_valid.data_ptr(), out.data_ptr(), B,
        Sq, Sk, Hq, Hkv, D, int(causal), int(window), int(q_offset),
        int(q_block), int(k_block), float(scale),
        INSTANCES.index(geo.instance), geo.m_tiles, geo.blocks, geo.group,
        geo.smem_bytes, stream)
    _build.check(err, "flash_attention")
