"""Launch geometry of the ssd_scan kernel, computed in Python and passed to
the CUDA source, checked on the CPU: the state columns each block owns, the
grid, the shared memory a block asks for, how many blocks an SM holds and
how many waves a launch takes on the H100's 132 SMs."""

import pytest

from repro_torch.kernels.ssd_scan.ssd_scan import (
    MAX_BLOCK_SMEM, SM_SMEM, SMS, THREADS, column_tiles, cols_per_block,
    geometry, smem_bytes, update_rows)

DKS = [1, 16, 20, 100, 384, 512]
DVS = [1, 32, 33, 64, 384, 385]
CHUNKS = [8, 40, 200, 256, 1024]


@pytest.mark.parametrize("dk", DKS)
@pytest.mark.parametrize("dv", DVS)
def test_column_tiles_cover_every_state_column_once(dk, dv):
    for W in CHUNKS:
        geo = geometry(8, 4, dk, dv, W)
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
