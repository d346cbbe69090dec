"""Launch geometry of the ssd_scan kernel, computed in Python and passed to
the CUDA source, checked on the CPU: the state columns each block owns, the
grid, the shared memory a block asks for, how many blocks an SM holds and
how many waves a launch takes on the H100's 132 SMs; for the chunked
instance also the blocks of its three launches, its workspace, and the
instance ``pick`` chooses at the shapes the paths run."""

import itertools

import pytest

from repro_torch.kernels.ssd_scan.ssd_scan import (
    BLOCK_RESERVED_SMEM, C_LAUNCH_BOUND_BLOCKS, C_MAX_CHUNK, C_MAX_DK,
    CARRY_THREADS, CHUNKED, MAX_BLOCK_SMEM, SERIAL, SM_SMEM, SMS, THREADS,
    Y_GROUP, Y_WARPS, chunked_smem, column_tiles, cols_per_block, geometry,
    pick, smem_bytes, update_rows, warp_groups, workspace, y_block)

DKS = [1, 16, 20, 100, 384, 512]
DVS = [1, 32, 33, 64, 384, 385]
CHUNKS = [8, 40, 200, 256, 1024]


@pytest.mark.parametrize("dk", DKS)
@pytest.mark.parametrize("dv", DVS)
def test_column_tiles_cover_every_state_column_once(dk, dv):
    for W in CHUNKS:
        geo = geometry(8, 4, dk, dv, W, instance=SERIAL)
        tiles = column_tiles(dv, geo.cols)
        assert geo.grid == (len(tiles), 4, 8)
        assert geo.blocks == len(tiles) * 4 * 8
        seen = [c for c0, c1 in tiles for c in range(c0, c1)]
        assert seen == list(range(dv))
        assert all(0 < c1 - c0 <= geo.cols for c0, c1 in tiles)
        # shared memory: within a block's limit, and the blocks an SM holds
        # fit its 228 KB together
        assert geo.smem_bytes == smem_bytes(dk, W, geo.cols)
        assert 0 < geo.smem_bytes <= MAX_BLOCK_SMEM
        assert geo.blocks_per_sm >= 1
        assert geo.blocks_per_sm * geo.smem_bytes <= SM_SMEM
        assert geo.waves == geo.blocks / (SMS * geo.blocks_per_sm)
        assert geo.threads == 256
        # the state update's row groups hold every (padded) state row
        rows = update_rows(dk, geo.cols)
        assert rows in ((12, 4) if geo.cols == 64 else (8, 4))
        assert THREADS // (geo.cols // 8) * rows >= -(-dk // 16) * 16


@pytest.mark.parametrize("dk", DKS)
@pytest.mark.parametrize("dv", DVS)
def test_column_width(dk, dv):
    """16 columns at dv <= 16 (dv = 1 idles no wide tile), 64 only where the
    state tile leaves room for the rest (dk <= 384), else 32."""
    cols = cols_per_block(dk, dv)
    assert cols in (16, 32, 64)
    assert (cols == 16) == (dv <= 16)
    assert cols != 64 or (dk <= 384 and dv > 32)


def test_headline_scan_grid():
    # the mLSTM's launch: B=8 H=4 dk=384 dv=385 (v and the ones column),
    # one chunk of 256: six 64-column tiles and one of the ones column
    geo = geometry(8, 4, 384, 385, 256)
    assert (geo.cols, geo.grid, geo.blocks, geo.smem_bytes,
            geo.blocks_per_sm) == (64, (7, 4, 8), 224, 226304, 1)
    assert geo.waves == pytest.approx(224 / 132)
    assert column_tiles(385, 64)[-1] == (384, 385)
    # the normalizer alone (dv = 1): one 16-column tile per (b, h)
    assert geometry(8, 4, 384, 1, 256).grid == (1, 4, 8)
    assert geometry(8, 4, 384, 385, 256).instance == SERIAL


def test_smem_layout_bytes():
    # dk 384 -> rows of 392 bf16: state 384 x 64 fp32, q tile 64 rows (more
    # than the 32 x 384 fp32 k_scaled tile), two 32-key k tiles, two 32 x 64
    # fp32 v tiles, a 64 x 36 score tile, and two fp32 gate arrays of W
    assert smem_bytes(384, 256, 64) == (384 * 64 * 4 + 64 * 392 * 2
                                        + 2 * 32 * 392 * 2 + 2 * 32 * 64 * 4
                                        + 64 * 36 * 4 + 2 * 256 * 4)
    # at dk 16 the k_scaled tile (32 keys x 32 row groups x 4 rows) is the
    # larger
    assert smem_bytes(16, 64, 64) == (16 * 64 * 4 + 32 * 128 * 4
                                      + 2 * 32 * 24 * 2 + 2 * 32 * 64 * 4
                                      + 64 * 36 * 4 + 2 * 64 * 4)
    # dk is padded to 16 (the mma's k step); the largest launch fills a
    # block's shared memory exactly
    assert smem_bytes(100, 40, 32) == smem_bytes(112, 40, 32)
    assert smem_bytes(384, 1024, 64) == MAX_BLOCK_SMEM


@pytest.mark.parametrize("dk,dv,W", [
    (513, 64, 256), (1024, 1, 8), (0, 64, 256),   # dk outside 1..512
    (384, 385, 1025), (16, 64, 2048), (16, 64, 0),  # W outside 1..1024
    (384, 0, 256)])
def test_geometry_refuses_shapes_the_kernel_does_not_take(dk, dv, W):
    with pytest.raises(ValueError):
        geometry(8, 4, dk, dv, W)


# (B, H, dk, dv, W, nc): hymba's rows (rung 2048, the exact prompt, the
# tensor-parallel ranks' rung 128) and the ragged edges the card tests run
CHUNKED_CASES = [(8, 25, 16, 64, 256, 8), (1, 25, 16, 64, 256, 12),
                 (8, 7, 16, 64, 128, 1), (8, 13, 16, 64, 128, 1),
                 (2, 3, 1, 1, 256, 2), (1, 2, 20, 65, 256, 12),
                 (2, 2, 16, 63, 64, 1), (2, 2, 32, 130, 200, 3),
                 (3, 2, 8, 16, 8, 3), (1, 1, 16, 64, 100, 2)]


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_blocks_cover_every_row_tile_once(case):
    """The y launch and the local-state launch: a block per (column tile,
    chunk, h, b), each exactly once; in a y block the warps' 16-row groups
    cover the chunk's rows exactly once, the longer group of a warp first,
    and at W = 256 every warp walks the same number of 32-key tiles."""
    B, H, dk, dv, W, nc = case
    geo = geometry(B, H, dk, dv, W, nc)
    assert geo.instance == CHUNKED and geo.threads == 32 * Y_WARPS
    ncol = len(column_tiles(dv, geo.cols))
    assert geo.grid == (ncol, nc, H, B)
    seen = [y_block(geo, i) for i in range(geo.blocks)]
    assert sorted(seen) == sorted(itertools.product(
        range(ncol), range(nc), range(H), range(B)))
    groups = warp_groups(W)
    assert geo.row_groups == -(-W // Y_GROUP)
    assert sorted(g for gs in groups for g in gs) == list(range(
        geo.row_groups))
    rows = sorted(r for gs in groups for g in gs
                  for r in range(g * Y_GROUP, min(W, (g + 1) * Y_GROUP)))
    assert rows == list(range(W))
    tiles = [sum(g // 2 + 1 for g in gs) for gs in groups]
    assert all(gs == sorted(gs, reverse=True) for gs in groups)
    if W == C_MAX_CHUNK:
        assert tiles == [9] * Y_WARPS
    assert geo.carry_blocks * CARRY_THREADS >= (B * H * dk * dv
                                                if nc > 1 else 0)
    assert geo.launches == (3 if nc > 1 else 2)


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_chunked_workspace_is_what_the_wrapper_allocates(case):
    """Each chunk's local state and tot in fp32 where there are two chunks
    or more (the scan overwrites each local state with the state before its
    chunk); none with one chunk, whose local-state launch writes the final
    state itself. At rung 2048, 6.6 MB."""
    B, H, dk, dv, W, nc = case
    geo = geometry(B, H, dk, dv, W, nc)
    ws = workspace(geo, "cpu")
    if nc == 1:
        assert geo.workspace_floats == 0 and ws is None
    else:
        assert geo.workspace_floats == B * H * nc * (dk * dv + 1)
        assert ws.numel() == geo.workspace_floats
        assert ws.dtype.is_floating_point and ws.element_size() == 4
    if case == CHUNKED_CASES[0]:
        assert geo.workspace_floats * 4 == 6_560_000


@pytest.mark.parametrize("dk", [1, 16, 17, 32])
@pytest.mark.parametrize("W", [8, 128, 200, 256])
def test_chunked_blocks_per_sm_follow_shared_memory_and_launch_bounds(dk, W):
    geo = geometry(8, 25, dk, 64, W, 2)
    local, smem = chunked_smem(dk, W)
    assert (geo.local_smem, geo.smem_bytes) == (local, smem)
    assert smem <= MAX_BLOCK_SMEM and local <= MAX_BLOCK_SMEM
    assert geo.blocks_per_sm == min(SM_SMEM // (smem + BLOCK_RESERVED_SMEM),
                                    C_LAUNCH_BOUND_BLOCKS)
    assert geo.blocks_per_sm >= 1
    assert geo.blocks_per_sm * (smem + BLOCK_RESERVED_SMEM) <= SM_SMEM
    assert geo.waves == geo.blocks / (SMS * geo.blocks_per_sm)
    # at hymba's width two y blocks of 8 warps share an SM
    if dk <= 16:
        assert geo.blocks_per_sm == 2


def test_chunked_smem_layout_bytes():
    # dk 16 -> rows of 24 bf16. Local: two 64-key tiles of k and of v
    # (rows of 72 bf16) and their fp32 copy, more than four 16 x 64 fp32
    # partial states, and two fp32 arrays of W. y: the 16 x 64 state, eight
    # 16 x 36 score tiles, the chunk's 256 x 64 v in fp32 and its q and k
    # rows, two fp32 arrays of W: 114,688 bytes, two blocks an SM
    assert chunked_smem(16, 256) == (
        2 * 64 * (24 + 72) * 2 + 64 * (16 + 64) * 4 + 2 * 256 * 4,
        16 * 64 * 4 + 8 * 16 * 36 * 4 + 256 * 64 * 4 + 2 * 256 * 24 * 2
        + 2 * 256 * 4)
    assert chunked_smem(16, 256)[1] == 114_688
    assert 4 * 32 * 64 * 4 < 2 * 64 * (40 + 72) * 2 + 64 * (32 + 64) * 4
    assert chunked_smem(20, 40) == chunked_smem(32, 40)
    # a ragged chunk stages its rows rounded up to 32 (only the gates
    # differ between 200 and 224 rows)
    assert chunked_smem(16, 224)[1] - chunked_smem(16, 200)[1] == 2 * 24 * 4


# PERF.md's ssd_scan rows: (B, H, dk, dv, W, nc) -> the instance
PERF_ROWS = [((8, 4, 384, 385, 256, 1), SERIAL),    # the mLSTM's launch (e)
             ((8, 4, 384, 384, 256, 1), SERIAL),    # (a)
             ((8, 4, 384, 1, 256, 1), SERIAL),      # (b) the normalizer
             ((8, 4, 384, 384, 256, 2), SERIAL),    # (c) two chunks
             ((1, 4, 384, 384, 8, 1), SERIAL),      # (d) B 1, S 8
             ((8, 25, 16, 64, 256, 8), CHUNKED),    # hymba rung 2048
             ((1, 25, 16, 64, 256, 12), CHUNKED),   # the exact prompt
             ((8, 7, 16, 64, 128, 1), CHUNKED),     # TP rank of 4
             ((8, 13, 16, 64, 128, 1), CHUNKED)]    # TP rank of (2, 2)


@pytest.mark.parametrize("row,instance", PERF_ROWS)
def test_pick_at_every_row_of_the_table(row, instance):
    B, H, dk, dv, W, nc = row
    assert pick(dk, dv, W, B, H, nc) == instance
    assert geometry(B, H, dk, dv, W, nc).instance == instance
    assert (instance == CHUNKED) == (dk <= C_MAX_DK and W <= C_MAX_CHUNK)


def test_chunked_instance_refuses_wide_states():
    with pytest.raises(ValueError):
        geometry(8, 4, 33, 64, 256, 1, instance=CHUNKED)
    with pytest.raises(ValueError):           # a chunk a y block cannot hold
        geometry(8, 4, 16, 64, 512, 1, instance=CHUNKED)
    assert pick(16, 64, 512, 8, 4, 1) == SERIAL
    with pytest.raises(ValueError):
        geometry(8, 4, 16, 64, 256, 1, instance="tiled")
