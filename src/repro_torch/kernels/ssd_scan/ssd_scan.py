"""Binding of the CUDA chunked linear-attention scan (``csrc/ssd_scan.cu``).

Replaces ``src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan`` and adds
``initial_state`` and the model layout; the source's header says what
bounds it on the H100 and how its design answers that. Two instances
compute the same function: ``serial`` (a block per state column tile of a
(b, h) walks the chunks in order) and ``chunked`` (dk <= 32, chunks of up
to 256: the chunks' local states in parallel, a scan over them, then y a
block per chunk). :func:`pick` chooses one from static shapes; the launch
geometry is computed here (:func:`geometry`), where the CPU tests reach it,
and passed to the kernel, which refuses any other."""

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
# blocks per SM the serial kernel's launch bounds promise: one, so that a
# thread may hold its share of the state update in up to 255 registers
LAUNCH_BOUND_BLOCKS = 1

SERIAL, CHUNKED = "serial", "chunked"
INSTANCES = (SERIAL, CHUNKED)
# the chunked instance: local-state blocks of 4 warps over 64-key tiles; y
# blocks of 8 warps, a chunk of up to 256 rows a block in 16-row groups (two
# a warp), 32-key tiles, a warp's 16 x 32 score tile rows padded by 4
C_COLS = 64
C_KEYS = 32
C_PLD = C_KEYS + 4
C_MAX_DK = 32
L_KEYS = 64                 # keys a staged tile of the local-state launch
L_STAGES = 2                # its bf16 tiles: one used, the next in flight
Y_WARPS = 8
Y_THREADS = 32 * Y_WARPS
Y_GROUP = 16                # chunk rows a warp's group
C_MAX_CHUNK = 2 * Y_WARPS * Y_GROUP   # 256
C_LAUNCH_BOUND_BLOCKS = 2   # y blocks an SM the launch bounds promise
CARRY_THREADS = 256         # the scan over chunks: a thread a state element


class Geometry(NamedTuple):
    cols: int             # state columns per block: 16, 32 or 64
    grid: tuple           # serial: (column tiles, H, B); chunked, the
                          # local-state and y launches: (column tiles,
                          # chunks, H, B)
    blocks: int           # blocks of the launch (chunked: of the local-state
                          # and of the y launch, each)
    threads: int
    smem_bytes: int       # dynamic shared memory per (y) block
    blocks_per_sm: int    # resident at once, by shared memory and launch bounds
    waves: float          # blocks / (SMS * blocks_per_sm)
    instance: str = SERIAL
    chunks: int = 1       # nc = S / W
    row_groups: int = 0   # chunked: 16-row groups of a chunk
    local_smem: int = 0   # chunked: the local-state launch's shared memory a block
    carry_blocks: int = 0     # chunked: blocks of the scan over chunks
    workspace_floats: int = 0  # chunked: fp32 local states and tot
    launches: int = 1


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


def pick(dk: int, dv: int, W: int, B: int, H: int, nc: int) -> str:
    """The instance for a call's static shapes: the chunked one where dk <=
    32 and the chunk fits a y block (W <= 256; hymba's state is 16 wide, a
    chunk's local state 4 KB, and the serial instance's one block a (b, h)
    walking 8-12 chunks in order leaves the card idle), the serial one
    elsewhere (the mLSTM's dk 384: its 576 KB state a (b, h) would make the
    chunk states' workspace and scan cost more than the chunk walk;
    PERF.md §6)."""
    return CHUNKED if dk <= C_MAX_DK and W <= C_MAX_CHUNK else SERIAL


def chunked_dkp(dk: int) -> int:
    """dk padded to the mma's k step: 16 or 32."""
    return 16 if dk <= 16 else 32


def chunked_smem(dk: int, W: int) -> tuple:
    """Dynamic shared memory of the chunked instance's (local-state, y)
    blocks, as the kernel lays them out. Local: ``L_STAGES`` 64-key tiles
    of bf16 k (rows of dkp + 8) and v (64 columns, rows of 72) and a 64-key
    fp32 copy of k_scaled and v, whose room the four warps' partial dkp x
    64 fp32 states take at the end; two fp32 arrays of the chunk (cum, the
    k scales). y: the dkp x 64 fp32 state before the chunk; each warp's
    16 x 36 fp32 score tile; the chunk's v in fp32 (64 columns) and its q
    and k in bf16 (rows of dkp + 8), W rounded up to 32 rows; cum and log_i
    of the chunk."""
    dkp = chunked_dkp(dk)
    ld = dkp + 8
    wp = -(-W // C_KEYS) * C_KEYS
    local = (max(L_STAGES * L_KEYS * (ld + C_COLS + 8) * 2
                 + L_KEYS * (dkp + C_COLS) * 4, 4 * dkp * C_COLS * 4)
             + 2 * W * 4)
    y = (dkp * C_COLS * 4 + Y_WARPS * 16 * C_PLD * 4 + wp * C_COLS * 4
         + 2 * wp * ld * 2 + 2 * W * 4)
    return local, y


def workspace_floats(B: int, H: int, dk: int, dv: int, nc: int) -> int:
    """The chunked instance's fp32 workspace: each chunk's local state
    [B, H, nc, dk, dv] (overwritten by the state before it) and its tot
    [B, H, nc]; none with one chunk."""
    return B * H * nc * (dk * dv + 1) if nc > 1 else 0


def geometry(B: int, H: int, dk: int, dv: int, W: int, nc: int = 1,
             instance: Optional[str] = None) -> Geometry:
    """The launch of a scan over [B, nc * W, H, dk] keys and [B, nc * W, H,
    dv] values in chunks of W, on the instance :func:`pick` chooses (or
    ``instance``, to measure one); raises where the kernel takes no such
    shape."""
    if not (1 <= dk <= MAX_DK and 1 <= W <= MAX_CHUNK and dv >= 1
            and B >= 1 and H >= 1 and nc >= 1):
        raise ValueError(f"ssd_scan: the kernel takes 1 <= dk <= {MAX_DK}, "
                         f"chunk <= {MAX_CHUNK}, dv >= 1; got dk={dk} dv={dv} "
                         f"chunk={W} B={B} H={H} chunks={nc}")
    inst = instance or pick(dk, dv, W, B, H, nc)
    if inst == CHUNKED:
        if dk > C_MAX_DK or W > C_MAX_CHUNK:
            raise ValueError(f"ssd_scan: the chunked instance takes dk <= "
                             f"{C_MAX_DK} and chunk <= {C_MAX_CHUNK}; got "
                             f"dk={dk} chunk={W}")
        ncol = -(-dv // C_COLS)
        local, smem = chunked_smem(dk, W)
        grid = (ncol, nc, H, B)
        blocks = ncol * nc * H * B
        per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM),
                     C_LAUNCH_BOUND_BLOCKS)
        carry = -(-B * H * dk * dv // CARRY_THREADS) if nc > 1 else 0
        return Geometry(C_COLS, grid, blocks, Y_THREADS, smem, per_sm,
                        blocks / (SMS * per_sm), CHUNKED, nc,
                        -(-W // Y_GROUP), local, carry,
                        workspace_floats(B, H, dk, dv, nc),
                        3 if nc > 1 else 2)
    if inst != SERIAL:
        raise ValueError(f"ssd_scan: no instance {inst!r}")
    cols = cols_per_block(dk, dv)
    smem = smem_bytes(dk, W, cols)
    grid = (-(-dv // cols), H, B)
    blocks = grid[0] * H * B
    per_sm = min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM),
                 LAUNCH_BOUND_BLOCKS)
    return Geometry(cols, grid, blocks, THREADS, smem, per_sm,
                    blocks / (SMS * per_sm), SERIAL, nc)


def y_block(geo: Geometry, blk: int) -> tuple:
    """(column tile, chunk, h, b) of the chunked instance's y block ``blk``
    (and of its local-state block ``blk``), as the kernels decode their
    index."""
    ncol, nc, H, _ = geo.grid
    bh = blk // (ncol * nc)
    return blk % ncol, (blk // ncol) % nc, bh % H, bh // H


def warp_groups(W: int) -> list:
    """The 16-row groups of a chunk of W rows each of a y block's warps
    takes, in its order: group 2 * Y_WARPS - 1 - w (the longer), then w;
    the rows of group j are [16 j, 16 j + 16) below W."""
    ngroups = -(-W // Y_GROUP)
    return [[g for g in (2 * Y_WARPS - 1 - w, w) if g < ngroups]
            for w in range(Y_WARPS)]


def workspace(geo: Geometry, device) -> Optional[torch.Tensor]:
    """The fp32 workspace a chunked launch needs (``torch.empty``), or
    None."""
    if not geo.workspace_floats:
        return None
    return torch.empty(geo.workspace_floats, dtype=torch.float32,
                       device=device)


def column_tiles(dv: int, cols: int) -> list:
    """[start, end) of the state columns each block along the grid's x axis
    owns, as the kernel cuts them."""
    return [(c, min(c + cols, dv)) for c in range(0, dv, cols)]


def _lib():
    lib = _build.load()
    fn = lib.ssd_scan_bf16
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_P]
        fn.restype = _I
        ch = lib.ssd_scan_chunked_bf16
        ch.argtypes = [_P] * 9 + [_I] * 9 + [_P]
        ch.restype = _I
    return lib


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_f: torch.Tensor, log_i: torch.Tensor,
             initial_state: Optional[torch.Tensor], y: torch.Tensor,
             state: torch.Tensor, *, chunk: int,
             instance: Optional[str] = None) -> None:
    """q, k: [B, S, H, dk], v, y: [B, S, H, dv] (bf16); log_f, log_i:
    [B, S, H], initial_state (or None: zeros), state: [B, H, dk, dv] (fp32);
    all contiguous, ``chunk`` divides S. ``instance`` forces one (to
    measure it); None: :func:`pick`. Launches on the current stream."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    W = int(chunk)
    geo = geometry(B, H, dk, dv, W, S // W, instance)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    s0 = None if initial_state is None else initial_state.data_ptr()
    lib = _lib()
    if geo.instance == SERIAL:
        err = lib.ssd_scan_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            log_i.data_ptr(), s0, y.data_ptr(), state.data_ptr(), B, S, H,
            dk, dv, W, geo.cols, geo.smem_bytes, stream)
    else:
        ws = workspace(geo, q.device)
        err = lib.ssd_scan_chunked_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
            log_i.data_ptr(), s0, y.data_ptr(), state.data_ptr(),
            None if ws is None else ws.data_ptr(), B, S, H, dk, dv, W,
            geo.blocks, geo.local_smem, geo.smem_bytes,
            stream)
    _build.check(err, "ssd_scan")
