"""Binding of the CUDA chunked linear-attention scan (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan`` and adds
``initial_state`` and the model layout; the source's header says what
bounds it on the H100 and how its design answers that. The launch geometry
is computed here (:func:`geometry`), where the CPU tests reach it, and
passed to the kernel, which refuses any other."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int

SMS = 132                   # streaming multiprocessors of an H100 SXM
THREADS = 256               # threads per block
ROWS = 64                   # chunk rows per row tile
KEYS = 32                   # chunk keys per key tile
MAX_DK = 512
MAX_CHUNK = 1024
MAX_BLOCK_SMEM = 232448     # a block's dynamic shared memory on sm_90
SM_SMEM = 233472            # shared memory of one SM
BLOCK_RESERVED_SMEM = 1024  # what the runtime keeps per resident block
# blocks per SM the kernel's launch bounds promise: one, so that a thread may
# hold its share of the state update in up to 255 registers
LAUNCH_BOUND_BLOCKS = 1


class Geometry(NamedTuple):
    cols: int             # state columns per block: 16, 32 or 64
    grid: tuple           # (column tiles, H, B)
    blocks: int
    threads: int
    smem_bytes: int       # dynamic shared memory per block
    blocks_per_sm: int    # resident at once, by shared memory and launch bounds
    waves: float          # blocks / (SMS * blocks_per_sm)


def cols_per_block(dk: int, dv: int) -> int:
    """16 columns where dv <= 16 (dv = 1 must not idle a wide tile), 32 where
    dv <= 32 or where a 64-column state tile would not leave room for the
    rest at dk > 384, else 64: half the blocks of 32 columns, so half the
    recomputed q k^T and staged keys per state column."""
    if dv <= 16:
        return 16
    return 32 if dv <= 32 or dk > 384 else 64


def update_rows(dk: int, cols: int) -> int:
    """State rows each thread accumulates in the state update (8 columns a
    thread, so THREADS / (cols / 8) row groups): 4 where that covers dk
    padded to 16, else 12 at 64 columns (dk <= 384) or 8 below (dk <= 512).
    The kernel has one instance per (cols, rows)."""
    groups = THREADS // (cols // 8)
    if 4 * groups >= -(-dk // 16) * 16:
        return 4
    return 12 if cols == 64 else 8


def smem_bytes(dk: int, W: int, cols: int) -> int:
    """Dynamic shared memory of a block, as the kernel lays it out: the fp32
    state tile; the bf16 q row tile, whose room the fp32 k_scaled tile
    (KEYS rows of every thread's update rows) takes in the state update;
    two bf16 k key tiles; two fp32 v key tiles; the score tile; two fp32
    gate arrays of the chunk. q and k rows hold dk padded to 16 plus 8
    bf16."""
    dkp = -(-dk // 16) * 16
    ld = dkp + 8
    k_scaled = KEYS * THREADS // (cols // 8) * update_rows(dk, cols) * 4
    return (dkp * cols * 4 + max(ROWS * ld * 2, k_scaled)
            + 2 * KEYS * ld * 2 + 2 * KEYS * cols * 4
            + ROWS * (KEYS + 4) * 4 + 2 * W * 4)


def geometry(B: int, H: int, dk: int, dv: int, W: int) -> Geometry:
    """The launch of a scan over [B, *, H, dk] keys and [B, *, H, dv] values
    in chunks of W; raises where the kernel takes no such shape."""
    if not (1 <= dk <= MAX_DK and 1 <= W <= MAX_CHUNK and dv >= 1
            and B >= 1 and H >= 1):
        raise ValueError(f"ssd_scan: the kernel takes 1 <= dk <= {MAX_DK}, "
                         f"chunk <= {MAX_CHUNK}, dv >= 1; got dk={dk} dv={dv} "
                         f"chunk={W} B={B} H={H}")
    cols = cols_per_block(dk, dv)
    smem = smem_bytes(dk, W, cols)
    grid = (-(-dv // cols), H, B)
    blocks = grid[0] * H * B
    per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM),
                 LAUNCH_BOUND_BLOCKS)
    return Geometry(cols, grid, blocks, THREADS, smem, per_sm,
                    blocks / (SMS * per_sm))


def column_tiles(dv: int, cols: int) -> list:
    """[start, end) of the state columns each block along the grid's x axis
    owns, as the kernel cuts them."""
    return [(c, min(c + cols, dv)) for c in range(0, dv, cols)]


def _fn():
    lib = _build.load()
    fn = lib.ssd_scan_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        fn.restype = _I
    return fn


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_f: torch.Tensor, log_i: torch.Tensor,
             initial_state: Optional[torch.Tensor], y: torch.Tensor,
             state: torch.Tensor, *, chunk: int) -> None:
    """q, k: [B, S, H, dk], v, y: [B, S, H, dv] (bf16); log_f, log_i:
    [B, S, H], initial_state (or None: zeros), state: [B, H, dk, dv] (fp32);
    all contiguous, ``chunk`` divides S. Launches on the current stream."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    geo = geometry(B, H, dk, dv, int(chunk))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                log_i.data_ptr(),
                None if initial_state is None else initial_state.data_ptr(),
                y.data_ptr(), state.data_ptr(), B, S, H, dk, dv, int(chunk),
                geo.cols, geo.smem_bytes, stream)
    _build.check(err, "ssd_scan")
