"""Launch geometry of the two attention kernels, computed in Python and
passed to the CUDA sources, checked on the CPU: the prefill kernel's M tiles
(flattened (query row, head in group) pairs) and the key range each tile
loads; the decode kernel's cluster size and how its blocks split a sample's
valid positions."""

import pytest

from repro_torch.kernels.decode_attention.decode_attention import (
    BLOCK_G, MAX_CLUSTER, block_warps, cluster_size, cluster_slices,
    head_groups)
from repro_torch.kernels.flash_attention.flash_attention import (
    M_TILE, geometry, tile_key_range, tile_pairs)

PREFILL_SHAPES = [
    # (B, Sq, Hq, Hkv, D)
    (8, 256, 15, 5, 64),     # smollm-360m at rung 256: G = 3
    (2, 100, 15, 5, 64),     # Sq * G = 300, not a multiple of 64
    (1, 1, 4, 4, 32),        # one row, G = 1
    (2, 40, 4, 4, 64),       # G = 1
    (2, 50, 16, 2, 64),      # G = 8, Sq * G = 400
    (1, 37, 6, 2, 128),      # D = 128
    (8, 2048, 15, 5, 64),    # smollm's context
]


@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_m_tiles_cover_every_row_and_head_once(shape):
    B, Sq, Hq, Hkv, D = shape
    G = Hq // Hkv
    geo = geometry(B, Sq, Hq, Hkv, D)
    assert geo.blocks == geo.m_tiles * Hkv * B
    seen = [p for t in range(geo.m_tiles) for p in tile_pairs(t, Sq, G)]
    assert sorted(seen) == [(r, g) for r in range(Sq) for g in range(G)]
    assert all(0 < len(tile_pairs(t, Sq, G)) <= M_TILE
               for t in range(geo.m_tiles))
    # q tile + two K and two V tiles of 64 rows, D + 8 bf16 each
    assert geo.smem_bytes == 320 * (D + 8) * 2
    assert (geo.smem_bytes > 48 * 1024) == (D == 128)


def test_headline_prefill_grid():
    geo = geometry(8, 256, 15, 5, 64)
    assert (geo.m_tiles, geo.blocks, geo.smem_bytes) == (12, 480, 46080)


KEY_CASES = [
    # (Sq, Sk, G, kv_valid, q_offset, window, causal)
    (256, 256, 3, 200, 0, 0, True),
    (256, 256, 3, 0, 0, 0, True),        # no valid key
    (16, 200, 3, 200, 184, 24, True),    # q_offset, window below a tile
    (16, 200, 3, 150, 184, 24, True),    # window entirely past kv_valid
    (100, 100, 8, 100, 0, 0, False),     # non-causal
    (1024, 1024, 1, 517, 0, 0, True),
]


@pytest.mark.parametrize("case", KEY_CASES)
def test_tile_key_range_holds_every_valid_key(case):
    """Every key some row of a tile may attend lies in the range the tile
    loads, and the range holds no key past kv_valid."""
    Sq, Sk, G, kvv, q_off, window, causal = case
    w = window if window > 0 else 1 << 30
    for t in range(geometry(1, Sq, G, 1, 64).m_tiles):
        start, end = tile_key_range(t, Sq, G, Sk, kvv, q_offset=q_off,
                                    window=window, causal=causal)
        assert start >= 0 and end <= kvv
        for row, _ in tile_pairs(t, Sq, G):
            qpos = q_off + row
            valid = [key for key in range(Sk) if key > qpos - w
                     and key < kvv and (key <= qpos or not causal)]
            assert all(start <= key < end for key in valid), (t, row)


@pytest.mark.parametrize("Smax", [24, 256, 2048])
@pytest.mark.parametrize("window", [0, 8, 20, 300])
def test_cluster_slices_cover_each_valid_position_once(Smax, window):
    """For lengths 0, 1, Smax, past Smax and in between, windowed or not,
    the blocks of a cluster read each valid position exactly once and
    nothing else, at every cluster size up to MAX_CLUSTER."""
    for length in sorted({0, 1, 2, 7, Smax // 2, Smax - 1, Smax, Smax + 5}):
        lo = max(0, length - window) if window > 0 else 0
        valid = list(range(lo, min(length, Smax)))
        for c in range(1, MAX_CLUSTER + 1):
            slices = cluster_slices(length, Smax, window, c)
            assert len(slices) == c
            got = [j for s0, s1 in slices for j in range(s0, s1)]
            assert got == valid, (length, c)
            # even slices: each block but the last ones takes ceil(n / c)
            assert max(s1 - s0 for s0, s1 in slices) == -(-len(valid) // c)


@pytest.mark.parametrize("B,Hkv,Smax,window", [
    (8, 5, 256, 0), (8, 5, 256, 32), (8, 5, 2048, 0), (1, 1, 8, 0),
    (64, 8, 4096, 0), (4, 2, 32, 0), (2, 2, 100, 20), (0, 5, 256, 0)])
def test_cluster_size_is_portable_and_divides_the_grid(B, Hkv, Smax, window):
    c = cluster_size(B, Hkv, Smax, window)
    assert 1 <= c <= MAX_CLUSTER and c & (c - 1) == 0
    grid = (c, Hkv, B)
    assert grid[0] % c == 0
    span = min(Smax, window) if window > 0 else Smax
    assert c == 1 or 16 * (c // 2) < span     # no block left without work


@pytest.mark.parametrize("G,groups,sizes", [
    (1, 1, [1]), (5, 1, [5]), (8, 1, [8]), (9, 2, [5, 4]),
    (13, 2, [7, 6]), (16, 2, [8, 8])])
def test_head_groups_keep_a_block_within_eight_heads(G, groups, sizes):
    """The kernel cuts a kv head's G query heads into ``head_groups(G)``
    grid rows of ceil(G / groups) heads but the last (csrc/
    decode_attention.cu: ``Gb``, ``g0``): every head in one group, none
    holding more than ``BLOCK_G``; hymba at model = 2 (G = 13) takes 7
    and 6. At G <= 8 one group: the launch every earlier shape had."""
    assert head_groups(G) == groups
    gb = -(-G // groups)
    got = [min(gb, G - g0) for g0 in range(0, G, gb)]
    assert got == sizes and sum(got) == G
    assert max(got) <= BLOCK_G


def test_headline_decode_cluster():
    # smollm-360m at 8 slots: 40 (kv head, sample) pairs, Smax 256
    assert cluster_size(8, 5, 256, 0) == 8
    assert cluster_size(8, 5, 2048, 0) == 8
    assert cluster_size(64, 5, 256, 0) == 1        # 320 pairs fill the card


@pytest.mark.parametrize("Smax,window,c,warps", [
    (256, 0, 8, 2),       # 32 positions a block: one step of two warps
    (2048, 0, 8, 4),      # 256 a block
    (2048, 32, 2, 2),     # the window bounds the slice, not Smax
    (128, 0, 2, 2),       # 64 a block: two steps of two warps
    (130, 0, 2, 4),
    (100, 0, 1, 4)])
def test_block_warps(Smax, window, c, warps):
    assert block_warps(Smax, window, c) == warps
