"""Binding of the CUDA decode-attention kernel (``csrc/decode_attention.cu``).

Replaces ``src/repro/kernels/decode_attention/decode_attention.py::
decode_attention``; the source's header says what bounds it on the H100 and
how its design answers that. The launch geometry is chosen here, where the
CPU tests reach it (:func:`geometry`): the blocks per (kv head, sample)
(:func:`splits`, from static shapes only, so a captured CUDA graph stays
valid as lengths change), the shared memory of the ring, the fp32 workspace
of the second launch above ``MAX_CLUSTER`` blocks; :func:`split_slices`
states how the kernel splits a sample's positions among those blocks."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

SMS = 132             # streaming multiprocessors of an H100 SXM
WARPS = 4             # a block; each warp takes 16 keys of a tile
TILE_KEYS = 16 * WARPS  # keys a ring stage holds
ROWS = 16             # M rows of the products: the query heads, zero past G
PAD = 8               # bf16 of padding a shared-memory row
MAX_CLUSTER = 8       # the portable thread-block cluster size
MAX_SPLITS = 256      # blocks a (kv head, sample) the workspace merge takes
BLOCK_KEYS = 128      # positions a block of a cluster is cut to: all in flight
FILL = 2 * SMS        # the long split's grid: two blocks an SM at least
SPLIT_KEYS = 512      # fewest positions a block gets where P > MAX_CLUSTER
MAX_KEYS = 4096       # a block of a cluster walks no more than this
SPLIT_MAX_KEYS = 8192  # nor a block of a workspace split, where it fills the card


def padded_dim(D: int) -> int:
    """The kernel instance's width: D rounded up to 16, 32, 64 or 128
    (the columns past D are zero in shared memory)."""
    return next(w for w in (16, 32, 64, 128) if D <= w)


def stages(D: int) -> int:
    """Ring stages: four tiles of 64 keys, three at the 128-wide instance
    (two blocks an SM either way, three at D <= 64)."""
    return 4 if padded_dim(D) <= 64 else 3


def blocks_per_sm(D: int) -> int:
    """Blocks an SM holds at once, as shared memory allows (the kernel's
    ``__launch_bounds__`` keeps registers within it): three at D <= 64,
    two at the 128-wide instance."""
    return 3 if padded_dim(D) <= 64 else 2


def wave(D: int) -> int:
    """The most blocks a cluster split launches: five sixths of the
    resident slots, since the blocks of a cluster must share one GPC and
    leave some SMs' slots unused."""
    return 5 * blocks_per_sm(D) * SMS // 6


def smem_bytes(D: int) -> int:
    """Dynamic shared memory a block: the q tile and the ring's K and V
    stages, rows of ``padded_dim(D) + PAD`` bf16."""
    return (ROWS + 2 * stages(D) * TILE_KEYS) * (padded_dim(D) + PAD) * 2


def splits(B: int, Hkv: int, D: int, Smax: int, window: int) -> int:
    """Blocks per (kv head, sample), from static shapes only (``span``: the
    longest range a sample can have, Smax or the window). A cache of at
    most ``MAX_CLUSTER * MAX_KEYS`` positions is split by a cluster: the
    power of two <= ``MAX_CLUSTER`` that cuts ``span`` into slices of at
    most ``BLOCK_KEYS`` (copied all at once by the ring's prologue), halved
    while the grid exceeds one :func:`wave` (a second wave of short blocks
    costs more than longer slices) unless a block would then walk more than
    ``MAX_KEYS``. A longer cache takes a workspace split of enough blocks
    to ``FILL`` the card and keep each at ``SPLIT_MAX_KEYS`` or fewer
    positions (the merge's cost grows with the split), at least
    ``SPLIT_KEYS`` each and at most ``MAX_SPLITS``."""
    span = min(Smax, window) if window > 0 else Smax
    pairs = B * Hkv
    if pairs == 0 or span <= 0:
        return 1
    if span > MAX_CLUSTER * MAX_KEYS:
        want = max(-(-FILL // pairs), -(-span // SPLIT_MAX_KEYS))
        return min(want, span // SPLIT_KEYS, MAX_SPLITS)
    c = 1
    while c < MAX_CLUSTER and c * BLOCK_KEYS < span:
        c *= 2
    while c > 1 and c * pairs > wave(D) and -(-span // (c // 2)) <= MAX_KEYS:
        c //= 2
    return c


class Geometry(NamedTuple):
    splits: int            # blocks per (kv head, sample)
    blocks: int            # of the main launch: splits * Hkv * B
    grid: tuple            # the main launch's (x, y, z)
    cluster: bool          # splits <= MAX_CLUSTER: merged in one launch
    launches: int          # CUDA launches a call: 1, or 2 with the merge
    stages: int            # ring stages of TILE_KEYS keys
    tile_bytes: int        # one stage's K and V tiles in shared memory
    smem_bytes: int        # dynamic shared memory a block
    workspace_floats: int  # fp32 partials (acc, m, l) of the merge, or 0


@functools.lru_cache(maxsize=None)
def geometry(B: int, Hkv: int, G: int, D: int, Smax: int, window: int,
             p: Optional[int] = None) -> Geometry:
    """The launch for these shapes at ``p`` blocks per (kv head, sample);
    ``p`` None: the wrapper's choice, :func:`splits`."""
    p = splits(B, Hkv, D, Smax, window) if p is None else p
    cluster = p <= MAX_CLUSTER
    return Geometry(
        splits=p, blocks=p * Hkv * B,
        grid=(p, Hkv, B) if cluster else (Hkv, p, B), cluster=cluster,
        launches=1 if cluster else 2, stages=stages(D),
        tile_bytes=2 * TILE_KEYS * (padded_dim(D) + PAD) * 2,
        smem_bytes=smem_bytes(D),
        workspace_floats=0 if cluster else B * Hkv * p * G * (D + 2))


def split_slices(length: int, Smax: int, window: int, p: int) -> list:
    """[start, end) of the positions each of the ``p`` blocks of a (kv
    head, sample) reads for a sample of ``length`` valid positions: even
    slices of [max(0, length - window), min(length, Smax)), as the kernel
    cuts them."""
    hi = min(length, Smax)
    lo = max(0, length - window) if window > 0 else 0
    per = -(-max(0, hi - lo) // p)
    return [(lo + r * per, max(lo + r * per, min(lo + (r + 1) * per, hi)))
            for r in range(p)]


def _fn():
    lib = _build.load()
    fn = lib.decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       ctypes.c_float, _I, _I, _P]
        fn.restype = _I
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor,
                     out: torch.Tensor, *, window: int, scale: float,
                     p: Optional[int] = None) -> int:
    """q, out: [B, Hq, D]; k/v_cache: [B, Smax, Hkv, D] (bf16, contiguous);
    lengths: [B] int32. Launches on the current stream at ``p`` blocks per
    (kv head, sample) (None: :func:`splits`), with the merge's workspace
    allocated here where ``p > MAX_CLUSTER``; returns the CUDA launches
    made (``Geometry.launches``)."""
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    geo = geometry(B, Hkv, Hq // Hkv, D, Smax, window, p)
    ws = None
    if geo.workspace_floats:
        ws = torch.empty(geo.workspace_floats, dtype=torch.float32,
                         device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), B, Smax, Hkv,
                Hq // Hkv, D, int(window), float(scale), geo.splits,
                geo.smem_bytes, stream)
    _build.check(err, "decode_attention")
    return geo.launches
