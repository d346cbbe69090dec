"""Launch geometry of the two attention kernels, computed in Python and
passed to the CUDA sources, checked on the CPU: the prefill kernel's
instance (from static shapes alone), its M tiles (flattened (query row,
head in group) pairs), the key range each tile loads and each key tile's
class (no mask, masked, not loaded) against a brute-force mask, the wgmma
instance's longest-first work list and its shared memory; the decode
kernel's split (blocks per (kv head, sample)), how its blocks split a
sample's valid positions, its shared memory and the merge's workspace."""

import inspect

import pytest

from repro_torch.kernels.decode_attention.decode_attention import (
    BLOCK_KEYS, FILL, MAX_CLUSTER, MAX_KEYS, MAX_SPLITS, PAD, ROWS,
    SMS, SPLIT_KEYS, SPLIT_MAX_KEYS, TILE_KEYS, WARPS,
    blocks_per_sm, padded_dim, split_slices, splits, wave)
from repro_torch.kernels.decode_attention.decode_attention import (
    geometry as decode_geometry)
from repro_torch.kernels.flash_attention.flash_attention import (
    GROUP_ROWS, INSTANCES, L2_BYTES, M_TILE, MMA, SMS, STAGES, WGMMA,
    block_items,
    geometry, key_tiles, pick, schedule, smem_bytes, tile_key_range,
    tile_pairs)

SMEM_LIMIT = 232448   # shared memory an H100 block may use (227 KB)

PREFILL_SHAPES = [
    # (B, Sq, Sk, Hq, Hkv, D, causal)
    (8, 256, 256, 15, 5, 64, True),     # smollm-360m at rung 256: G = 3
    (2, 100, 100, 15, 5, 64, True),     # Sq * G = 300, not a tile's multiple
    (1, 1, 1, 4, 4, 32, True),          # one row, G = 1
    (2, 40, 40, 4, 4, 64, True),        # G = 1
    (2, 50, 50, 16, 2, 64, True),       # G = 8, Sq * G = 400
    (1, 37, 37, 6, 2, 128, True),       # D = 128
    (8, 2048, 2048, 15, 5, 64, True),   # smollm's context
]


@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_m_tiles_cover_every_row_and_head_once(shape):
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    G = Hq // Hkv
    for inst in INSTANCES:
        geo = geometry(B, Sq, Sk, Hq, Hkv, D, causal, inst)
        assert geo.instance == inst and geo.m_tile == M_TILE[inst]
        assert geo.items == geo.m_tiles * Hkv * B
        assert geo.blocks == (geo.items if inst == MMA
                              else min(geo.items, SMS))
        seen = [p for t in range(geo.m_tiles)
                for p in tile_pairs(t, Sq, G, geo.m_tile)]
        assert sorted(seen) == [(r, g) for r in range(Sq) for g in range(G)]
        assert all(0 < len(tile_pairs(t, Sq, G, geo.m_tile)) <= geo.m_tile
                   for t in range(geo.m_tiles))
        assert geo.smem_bytes == smem_bytes(inst, D) <= SMEM_LIMIT
    # the mma instance: q tile + two K and two V tiles of 64 rows, D + 8
    # bf16 each
    mma = geometry(B, Sq, Sk, Hq, Hkv, D, causal, MMA)
    assert mma.smem_bytes == 320 * (D + 8) * 2
    assert (mma.smem_bytes > 48 * 1024) == (D == 128)


# the headline shapes and their geometry: (instance, M tile, key tile, M
# tiles, work items, blocks, threads, shared memory)
HEADLINE_PREFILL = [
    # prefill_32k's prompt (smollm-360m, B 1, 15 / 5 heads of 64): 768 M
    # tiles of 128 (row, head) pairs a kv head, 3,840 work items over 132
    # persistent blocks of 384 threads, a 4-stage ring of 128-key K and V
    # tiles
    ((1, 32768, 32768, 15, 5, 64, True),
     (WGMMA, 128, 128, 768, 3840, 132, 384, 169024)),
    # smollm-360m at rung 256, B 8: 240 work items of 128 rows
    ((8, 256, 256, 15, 5, 64, True),
     (WGMMA, 128, 128, 6, 240, 132, 384, 169024)),
    # hymba-1.5b's tensor-parallel rank at rung 128 (B 8, 7 / 1 heads): one
    # key tile, 56 items, so the mma instance's 112 blocks of 64 rows
    ((8, 128, 128, 7, 1, 64, True),
     (MMA, 64, 64, 14, 112, 112, 128, 46080)),
    # seamless-m4t-medium's encoder (B 8, S 1024, 16 / 16, non-causal)
    ((8, 1024, 1024, 16, 16, 64, False),
     (WGMMA, 128, 128, 8, 1024, 132, 384, 169024)),
    # dbrx-132b (B 8, S 256, 48 / 8 heads of 128): 64-key tiles
    ((8, 256, 256, 48, 8, 128, True),
     (WGMMA, 128, 64, 12, 768, 132, 384, 201792)),
]


def test_headline_prefill_grid():
    for shape, want in HEADLINE_PREFILL:
        geo = geometry(*shape)
        assert (geo.instance, geo.m_tile, geo.k_tile, geo.m_tiles, geo.items,
                geo.blocks, geo.threads, geo.smem_bytes) == want, shape


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("stages", [2, STAGES])
def test_shared_memory_fits_per_head_dim_and_stage_count(D, stages):
    """The wgmma instance's ring: ``stages`` K and V tiles of 128 keys (64
    at D = 128) in TMA's swizzled rows, two q tiles of each consumer group
    (rows of D + 8 bf16), two barriers a stage and 1024 bytes of
    alignment: within the 227 KB a block may use; the instance keeps
    ``STAGES``."""
    kt = 64 if D == 128 else 128
    need = (1024 + stages * 2 * kt * D * 2 + 2 * 128 * (D + 8) * 2
            + 16 * stages)
    assert need <= SMEM_LIMIT
    if stages == STAGES:
        assert smem_bytes(WGMMA, D) == need


@pytest.mark.parametrize("shape", [
    (1, 32768, 32768, 15, 5, 64, True), (8, 2048, 2048, 25, 5, 64, True),
    (2, 512, 2048, 15, 5, 64, True), (8, 1024, 1024, 16, 16, 64, False),
    (3, 300, 300, 13, 1, 32, True),
    (5, 8192, 8192, 15, 5, 64, True)])     # groups of 2 samples, then 1
def test_schedule_names_each_block_once_longest_first(shape):
    """The wgmma instance's launch order names every (M tile, kv head,
    sample) once, in groups of samples whose K and V fit half of L2;
    causal, each item's key range is no shorter than the next one's of its
    group (the M tiles descend); the persistent blocks run every item once
    between them, and where one group holds every sample their shares of
    the work differ by at most the longest item."""
    B, Sq, Sk, Hq, Hkv, D, causal = shape
    G = Hq // Hkv
    geo = geometry(B, Sq, Sk, Hq, Hkv, D, causal, WGMMA)
    order = schedule(geo, Hkv, B, causal)
    assert sorted(order) == [(t, h, b) for t in range(geo.m_tiles)
                             for h in range(Hkv) for b in range(B)]
    assert geo.blocks == min(geo.items, SMS)
    shares = [block_items(geo, j) for j in range(geo.blocks)]
    assert sorted(i for s in shares for i in s) == list(range(geo.items))

    def span(i):
        lo, hi = tile_key_range(order[i][0], Sq, G, Sk, Sk,
                                q_offset=Sk - Sq, window=0, causal=causal,
                                m_tile=geo.m_tile)
        return -(-(hi - lo) // geo.k_tile)
    work = [sum(span(i) for i in s) for s in shares]
    if geo.group == B:
        assert max(work) - min(work) <= max(span(i)
                                            for i in range(geo.items))
    assert geo.group * 4 * Sk * Hkv * D <= L2_BYTES // 2 or geo.group == 1
    groups = [b // geo.group for _, _, b in order]
    assert groups == sorted(groups)
    if causal:
        spans = []
        for t, _, _ in order:
            lo, hi = tile_key_range(t, Sq, G, Sk, Sk, q_offset=Sk - Sq,
                                    window=0, causal=True, m_tile=geo.m_tile)
            spans.append(hi - lo)
        for g in set(groups):
            mine = [x for x, gi in zip(spans, groups) if gi == g]
            assert all(x >= y for x, y in zip(mine, mine[1:]))


@pytest.mark.parametrize("shape", [
    (1, 32768, 32768, 15, 5, 64), (8, 256, 256, 15, 5, 64),
    (8, 128, 1024, 16, 16, 64), (8, 128, 128, 4, 1, 64),
    (2, 512, 2048, 15, 5, 64), (8, 256, 256, 48, 8, 128)])
def test_instance_depends_only_on_static_shapes(shape):
    """``pick`` reads (B, Sq, Sk, Hq, Hkv, D, causal) and nothing else: no
    tensor, no kv_valid, no q_offset or window, so a prefill captured in a
    CUDA graph keeps its instance as the data moves."""
    assert list(inspect.signature(pick).parameters) == [
        "B", "Sq", "Sk", "Hq", "Hkv", "D", "causal"]
    inst = pick(*shape, True)
    assert inst in INSTANCES
    assert geometry(*shape).instance == inst


KEY_CASES = [
    # (Sq, Sk, G, kv_valid, q_offset, window, causal)
    (256, 256, 3, 200, 0, 0, True),
    (256, 256, 3, 0, 0, 0, True),        # no valid key
    (16, 200, 3, 200, 184, 24, True),    # q_offset, window below a tile
    (16, 200, 3, 150, 184, 24, True),    # window entirely past kv_valid
    (100, 100, 8, 100, 0, 0, False),     # non-causal
    (1024, 1024, 1, 517, 0, 0, True),
    (600, 600, 5, 600, 0, 300, True),    # a binding window
    (300, 800, 3, 771, 500, 0, True),    # q_offset, kv_valid mid-tile
]


def _attends(Sq, Sk, kvv, q_off, window, causal, row, key):
    w = window if window > 0 else 1 << 30
    qpos = q_off + row
    return key > qpos - w and key < kvv and (key <= qpos or not causal)


@pytest.mark.parametrize("case", KEY_CASES)
def test_tile_key_range_holds_every_valid_key(case):
    """Every key some row of a tile may attend lies in the range the tile
    loads, and the range holds no key past kv_valid, in each instance's
    M tiles."""
    Sq, Sk, G, kvv, q_off, window, causal = case
    for inst in INSTANCES:
        geo = geometry(1, Sq, Sk, G, 1, 64, causal, inst)
        for t in range(geo.m_tiles):
            start, end = tile_key_range(t, Sq, G, Sk, kvv, q_offset=q_off,
                                        window=window, causal=causal,
                                        m_tile=geo.m_tile)
            assert start >= 0 and end <= kvv
            for row, _ in tile_pairs(t, Sq, G, geo.m_tile):
                valid = [key for key in range(Sk) if _attends(
                    Sq, Sk, kvv, q_off, window, causal, row, key)]
                assert all(start <= key < end for key in valid), (t, row)


@pytest.mark.parametrize("case", KEY_CASES)
@pytest.mark.parametrize("inst", INSTANCES)
def test_key_tile_classes_agree_with_the_mask(case, inst):
    """Each loaded key tile's class, per warp group, against a brute-force
    per-(row, key) mask: "free" (no mask) exactly where every valid row of
    the group attends every key of the tile; every attended key lies in a
    loaded tile; a tile that is not loaded holds no key any row of the
    block attends."""
    Sq, Sk, G, kvv, q_off, window, causal = case
    geo = geometry(1, Sq, Sk, G, 1, 64, causal, inst)
    for t in range(geo.m_tiles):
        tiles = key_tiles(geo, t, Sq, G, Sk, kvv, q_offset=q_off,
                          window=window, causal=causal)
        loaded = {key for t0, _ in tiles for key in range(t0, t0 + geo.k_tile)}
        rows = [m for m in range(t * geo.m_tile,
                                 min((t + 1) * geo.m_tile, Sq * G))]
        for m in rows:
            for key in range(Sk):
                if _attends(Sq, Sk, kvv, q_off, window, causal, m // G, key):
                    assert key in loaded, (t, m, key)
        for t0, classes in tiles:
            assert len(classes) == geo.m_tile // GROUP_ROWS
            for gi, cls in enumerate(classes):
                g0 = t * geo.m_tile + gi * GROUP_ROWS
                grows = [m // G for m in range(g0, min(g0 + GROUP_ROWS,
                                                       Sq * G))]
                every = bool(grows) and all(
                    _attends(Sq, Sk, kvv, q_off, window, causal, r, key)
                    for r in grows for key in range(t0, t0 + geo.k_tile))
                if inst == MMA:
                    assert cls == "masked"
                else:
                    assert (cls == "free") == every, (t, t0, gi)


@pytest.mark.parametrize("Smax", [24, 256, 2048])
@pytest.mark.parametrize("window", [0, 8, 20, 300])
def test_cluster_slices_cover_each_valid_position_once(Smax, window):
    """For lengths 0, 1, Smax, past Smax and in between, windowed or not,
    the blocks of a (kv head, sample) read each valid position exactly once
    and nothing else, at every split from 1 to the largest the wrapper
    chooses (``MAX_SPLITS``; the cluster sizes and the workspace merge)."""
    for length in sorted({0, 1, 2, 7, Smax // 2, Smax - 1, Smax, Smax + 5}):
        lo = max(0, length - window) if window > 0 else 0
        valid = list(range(lo, min(length, Smax)))
        for p in [*range(1, MAX_CLUSTER + 1), 9, 16, 53, 128, MAX_SPLITS]:
            slices = split_slices(length, Smax, window, p)
            assert len(slices) == p
            got = [j for s0, s1 in slices for j in range(s0, s1)]
            assert got == valid, (length, p)
            # even slices: each block but the last ones takes ceil(n / p)
            assert max(s1 - s0 for s0, s1 in slices) == -(-len(valid) // p)


# (B, Hkv, G, D, Smax, window): the paths' decode shapes (smollm, hymba's
# ring and global cache, seamless, internvl2, dbrx, the tensor-parallel
# ranks, the scenario model), the reference cells' long caches, and edges
DECODE_SHAPES = [
    (8, 5, 3, 64, 256, 0), (8, 5, 3, 64, 256, 32), (8, 5, 3, 64, 2048, 0),
    (8, 5, 5, 64, 2048, 0), (8, 5, 5, 64, 3200, 0), (8, 16, 1, 64, 1024, 0),
    (8, 2, 7, 64, 2112, 0), (8, 8, 6, 128, 512, 0), (8, 1, 4, 64, 256, 0),
    (4, 1, 13, 64, 2048, 0), (4, 2, 2, 16, 64, 0), (32, 5, 3, 64, 32768, 0),
    (1, 5, 5, 64, 524288, 0), (1, 5, 5, 64, 65536, 0), (1, 1, 1, 8, 8, 0),
    (0, 5, 3, 64, 256, 0), (64, 8, 8, 128, 4096, 0), (1, 5, 5, 64, 1 << 22,
                                                       0),
]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_split_fills_the_card_and_keeps_blocks_busy(shape):
    """Up to MAX_CLUSTER * MAX_KEYS positions the split is a cluster (a
    power of two <= 8, one launch): no more blocks than slices of
    BLOCK_KEYS need, as many as one ``wave(D)`` of resident blocks holds
    (five sixths of the slots shared memory leaves an SM), and no
    block walks more than MAX_KEYS positions. Past that, a workspace merge
    (9..MAX_SPLITS blocks, two launches) with SPLIT_KEYS to SPLIT_MAX_KEYS
    positions a block and two blocks an SM, unless the positions or
    MAX_SPLITS run out first."""
    B, Hkv, G, D, Smax, window = shape
    geo = decode_geometry(B, Hkv, G, D, Smax, window)
    p, pairs = geo.splits, B * Hkv
    span = min(Smax, window) if window > 0 else Smax
    assert geo.blocks == p * pairs
    # a cluster's blocks are consecutive along x; the workspace split puts
    # the kv heads there, so blocks that start together read one position
    # row of adjacent heads
    assert geo.grid == ((p, Hkv, B) if geo.cluster else (Hkv, p, B))
    if geo.cluster:
        assert span <= MAX_CLUSTER * MAX_KEYS or pairs == 0
        assert 1 <= p <= MAX_CLUSTER and p & (p - 1) == 0
        assert geo.launches == 1 and geo.workspace_floats == 0
        assert p == 1 or -(-span // (p // 2)) > BLOCK_KEYS
        assert -(-span // p) <= MAX_KEYS
        assert (p * pairs <= wave(D) or p == 1
                or -(-span // (p // 2)) > MAX_KEYS)
        assert (p == MAX_CLUSTER or -(-span // p) <= BLOCK_KEYS
                or 2 * p * pairs > wave(D) or pairs == 0)
    else:
        assert span > MAX_CLUSTER * MAX_KEYS
        assert MAX_CLUSTER < p <= MAX_SPLITS and geo.launches == 2
        assert span // p >= SPLIT_KEYS
        assert (geo.blocks >= FILL or p in (MAX_SPLITS, span // SPLIT_KEYS))
        assert -(-span // p) <= SPLIT_MAX_KEYS or p in (MAX_SPLITS,
                                                        span // SPLIT_KEYS)


@pytest.mark.parametrize("B,Hkv,Smax,window", [
    (8, 5, 256, 0), (32, 5, 32768, 0), (1, 5, 524288, 0), (8, 5, 2048, 16)])
def test_split_depends_only_on_static_shapes(B, Hkv, Smax, window):
    """The split is a function of (B, Hkv, D, Smax, window): not of the
    lengths, nor of G, so a decode step captured in a CUDA graph stays
    valid as the lengths move. D enters only through the blocks an SM
    holds: widths of one instance split alike."""
    assert list(inspect.signature(splits).parameters) == [
        "B", "Hkv", "D", "Smax", "window"]
    for D in (64, 128):
        p = splits(B, Hkv, D, Smax, window)
        for G in (1, 5, 16):
            assert decode_geometry(B, Hkv, G, D, Smax, window).splits == p
        for d in (D - 2, D - 14):
            assert splits(B, Hkv, d, Smax, window) == p


@pytest.mark.parametrize("D", [2, 8, 16, 20, 32, 48, 64, 100, 128])
def test_shared_memory_fits_the_ring_and_the_merge(D):
    """A block's dynamic shared memory is the q tile and the ring (at
    least three stages of 64 keys, K and V, rows of the instance's width
    plus 8 bf16); it fits the 227 KB a block may use, two blocks fit an SM
    (three at D <= 64), and the merge's fp32 scratch, aliased on the ring
    (csrc/decode_attention.cu: ``scratch_bytes``), fits in the ring."""
    geo = decode_geometry(8, 5, 3, D, 256, 0)
    w = padded_dim(D)
    assert w % 16 == 0 and D <= w and (w == 16 or w // 2 < D)
    assert geo.stages >= 3 and TILE_KEYS >= 64
    assert geo.tile_bytes == 2 * TILE_KEYS * (w + PAD) * 2
    assert geo.smem_bytes == geo.stages * geo.tile_bytes + ROWS * (w + PAD) * 2
    assert geo.smem_bytes <= SMEM_LIMIT
    per_sm = blocks_per_sm(D)
    assert per_sm == (3 if w <= 64 else 2)
    assert per_sm * (geo.smem_bytes + 1024) <= 233472   # 228 KB an SM
    scratch = ((WARPS + 1) * 16 * w + (2 * WARPS + 2 + MAX_CLUSTER) * 16) * 4
    assert scratch <= geo.stages * geo.tile_bytes


@pytest.mark.parametrize("B,Hkv,G,D,Smax,p", [
    (1, 5, 5, 64, 524288, 128), (1, 5, 5, 64, 65536, 53),
    (2, 1, 16, 128, 8192, 16), (3, 2, 1, 20, 9000, 17),
    (1, 5, 5, 64, 2048, 8), (4, 2, 7, 100, 4096, 9)])
def test_workspace_holds_the_partials(B, Hkv, G, D, Smax, p):
    """Above MAX_CLUSTER blocks each block writes its partial: acc [G][D]
    and m, l [G] in fp32, at [b][h][block] (csrc/decode_attention.cu); the
    workspace is exactly those, and a cluster needs none."""
    geo = decode_geometry(B, Hkv, G, D, Smax, 0, p)
    partials = B * Hkv * p
    want = 0 if p <= MAX_CLUSTER else partials * (G * D + 2 * G)
    assert geo.workspace_floats == want
    assert geo.launches == (1 if p <= MAX_CLUSTER else 2)


@pytest.mark.parametrize("shape,want", [
    # hymba-1.5b x long_500k's global caches: 64 blocks of 8,192
    # positions a (kv head, sample), 320 blocks, a workspace merge
    ((1, 5, 5, 64, 524288, 0), (64, 320, False)),
    # smollm-360m x decode_32k at B 32: clusters of 8, 1,280 blocks
    ((32, 5, 3, 64, 32768, 0), (8, 1280, True)),
    # smollm-360m served at 8 slots, Smax 256: clusters of 2, 128
    # positions a block at the longest
    ((8, 5, 3, 64, 256, 0), (2, 80, True)),
    # dbrx-132b (8 / 1 kv heads of 128 at 8 slots, Smax 512): 2 blocks, so
    # 128 blocks hold the card's two-an-SM slots once
    ((8, 8, 6, 128, 512, 0), (2, 128, True)),
])
def test_headline_decode_geometry(shape, want):
    geo = decode_geometry(*shape)
    assert (geo.splits, geo.blocks, geo.cluster) == want
    if shape[4] == 524288:
        assert geo.blocks >= 2 * SMS
