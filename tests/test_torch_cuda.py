"""The port's kernels on the card, each against its plain PyTorch version,
and ``LMServer`` on the card: its fused decode step replayed from a CUDA
graph against the same step run eagerly; the stacks that drive it (the
scenario runner, the LM cascade's two tiers, the control plane's lmserver
stack) on the card against the CPU.

Marked ``cuda``: where ``torch.cuda.is_available()`` is false each test
skips with that reason. The file imports no JAX, so it runs on a machine
that has only PyTorch: ``PYTHONPATH=src python -m pytest -q -m cuda
--noconftest tests/test_torch_cuda.py`` (the shared ``conftest.py`` imports
JAX). Tolerances: one bf16 rounding (rtol 2**-7) for
RMSNorm; for attention, whose kernels rescale per key tile and sum in other
orders (decode keeps p in fp32; flash sums P V in fp32 across key tiles
where the plain version rounds each key block's product to bf16), three
bf16 roundings of 1 absolute (outputs are averages of N(0, 1) values); for
the ssd_scan kernel, stated at its test."""

import pytest
import torch
from _torch_ties import record_logits, stream_divergence

from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

BF16_ULP = 2.0 ** -7
# the LM cascade's reduced smollm (2 layers, d_model 64, bf16), card vs
# CPU plain path at the steps whose inputs the two share: logits within
# this share of the CPU row's largest |logit|, about twice the largest
# difference seen on an H100 (1.35 %); a greedy stream may part from the
# CPU's where its two best logits lie closer than that
CASCADE_LOGIT_TOL = 0.03

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _randn(shape, gen, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)


def _tree_to(tree, dev):
    """A nested dict of tensors, each copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _rows(gen, dev, n, d, offset):
    """[n, d] bf16 rows starting ``offset`` values into a buffer (offset 1:
    the rows are contiguous but not 16-byte aligned)."""
    return _randn((n * d + offset,), gen, dev)[offset:].view(n, d)


# the paths' widths (decode rows at 8, prefill batches), d = 1001 (not a
# multiple of 8: the scalar path) and 20,000 rows of 960, more than the
# card holds warps at once
@pytest.mark.parametrize("n,d", [(1, 960), (37, 960), (8, 64), (5, 3000),
                                 (8, 1600), (8, 896), (8, 1024), (8, 6144),
                                 (2048, 896), (1024, 1024), (512, 6144),
                                 (8, 1001), (20000, 960)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_kernel(dev, n, d, residual, offset=0):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _rows(gen, dev, n, d, offset)
    w = _randn((d,), gen, dev, 0.25) + 1
    r = _rows(gen, dev, n, d, offset) if residual else None
    before = rmsnorm_op.launches
    got = rmsnorm_op(x, w, residual=r)
    torch.cuda.synchronize()
    assert rmsnorm_op.launches == before + 1
    want = rmsnorm_ref(x, w, residual=r)
    if residual:
        _close(got[0], want[0], 0, 0)         # one bf16 add: exact
        got, want = got[1], want[1]
    _close(got, want, BF16_ULP, 1e-5)


@pytest.mark.parametrize("n,d,offset", [(8, 960, 1), (37, 1600, 4),
                                        (2048, 896, 1), (5, 6144, 2)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_kernel_on_rows_not_16_byte_aligned(dev, n, d, offset,
                                                    residual):
    """Rows whose ``data_ptr()`` is 2, 4 or 8 bytes past a 16-byte
    boundary take the kernel's scalar path, held as test_rmsnorm_kernel
    holds the aligned ones."""
    from repro_torch.kernels.rmsnorm.rmsnorm import geometry
    assert geometry(n, d, False).vec == 1
    test_rmsnorm_kernel(dev, n, d, residual, offset)


def test_rmsnorm_pdl_launches_replay_from_a_graph(dev):
    """20 RMSNorm launches, each with programmatic dependent launch, chained
    after a ``torch.matmul`` (each norm reads the one before, every other
    one with the residual) and captured in one CUDA graph: the graph has a
    programmatic edge into each norm, and its replay equals the eager run
    bit for bit."""
    from repro_torch.kernels.rmsnorm.rmsnorm import PDL, programmatic_edges
    gen = torch.Generator(device=dev).manual_seed(0)
    a, b = _randn((8, 960), gen, dev), _randn((960, 960), gen, dev, 0.03)
    ws = [_randn((960,), gen, dev, 0.25) + 1 for _ in range(20)]

    def chain():
        x = s = torch.matmul(a, b)
        outs = []
        for i, w in enumerate(ws):
            if i % 2:
                s, x = rmsnorm_op(x, w, residual=s)
            else:
                x = rmsnorm_op(x, w)
            outs += [x, s]
        return outs
    eager = [t.clone() for t in chain()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        captured = chain()
    assert PDL
    assert programmatic_edges(graph.raw_cuda_graph()) == 20
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


DECODE_CASES = [
    # (B, Hq, Hkv, D, Smax, lengths, window)
    (4, 4, 2, 16, 32, [0, 1, 17, 32], 0),
    (4, 6, 2, 16, 24, [24, 0, 5, 13], 0),          # G = 3, Smax not 2^k
    (3, 6, 2, 32, 64, [64, 40, 0], 8),             # window > 0
    (8, 15, 5, 64, 256, [0, 1, 37, 128, 200, 255, 256, 64], 0),
    (8, 15, 5, 64, 256, [0, 1, 37, 128, 200, 255, 256, 64], 32),
    (2, 16, 2, 128, 100, [100, 51], 0),            # G = 8, D = 128
    (8, 15, 5, 64, 256, [1] * 8, 0),               # C = 8, most blocks empty
    # a window narrower than a block's share of Smax (256 / 8)
    (8, 15, 5, 64, 256, [0, 5, 20, 21, 100, 255, 256, 37], 20),
    (8, 15, 5, 64, 2048, [0, 1, 300, 1024, 2047, 2048, 1500, 700], 0),
    # the LM cascade at full width: Smax 64 splits each (kv head, sample)
    # over 4 blocks of 2 warps
    (4, 15, 5, 64, 64, [0, 9, 33, 64], 0),
    (4, 15, 5, 64, 64, [8, 11, 15, 16], 0),
    (3, 6, 2, 20, 50, [50, 7, 33], 0),             # D % 8: 4-byte loads
    (2, 8, 1, 100, 40, [40, 3], 0),                # G = 8, D = 100: 2 a lane
    (2, 16, 2, 128, 1000, [1000, 517], 0),         # G = 8, four warps
    (2, 6, 2, 20, 700, [700, 300], 0),             # 4-byte loads, four warps
    # hymba's rings: counts min(len + 1, W), full width (G = 5, W = 2048,
    # lengths past the window) and reduced (W = 16); its global cache
    (8, 25, 5, 64, 2048, [1, 300, 2048, 2048, 1500, 2048, 37, 2048], 0),
    (4, 4, 2, 16, 16, [1, 6, 16, 16], 0),
    (8, 25, 5, 64, 3200, [1, 2049, 3100, 3073, 500, 2048, 3200, 1000], 0),
    # the encdec, vlm and moe families at full width: seamless-m4t-medium
    # (G = 1, self and cross over a 1024-row memory), internvl2-1b (G = 7,
    # its text slots and its prefixed cache) and dbrx-132b (G = 6, D = 128)
    (8, 16, 16, 64, 1024, [9, 40, 128, 1, 77, 100, 64, 30], 0),
    (8, 16, 16, 64, 1024, [1024] * 8, 0),
    (8, 14, 2, 64, 256, [0, 9, 200, 256, 37, 128, 64, 241], 0),
    (4, 14, 2, 64, 2112, [2049, 2060, 2080, 2112], 0),
    (8, 48, 8, 128, 512, [33, 64, 200, 287, 0, 512, 129, 260], 0),
    # hymba's tensor-parallel ranks: padded(4) holds 7 / 1 heads (G = 7),
    # padded(2) 13 / 1 (G = 13: two head groups, 7 and 6), on the ring and
    # on the global cache; G = 9 and 16, the ends of two groups
    (8, 7, 1, 64, 2048, [1, 300, 2048, 2048, 1500, 2048, 37, 2048], 0),
    (4, 13, 1, 64, 2048, [1, 2048, 700, 2048], 0),
    (4, 13, 1, 64, 256, [0, 1, 129, 256], 0),
    (3, 18, 2, 64, 100, [100, 0, 37], 0),
    (2, 32, 2, 128, 300, [300, 150], 16),
    # caches longer than 8 clusters' blocks walk (32,768 positions), so the
    # split passes 8 blocks a (kv head, sample) and a second launch merges
    # the partials: B 1 at G 5 (53 blocks); lengths 0, 1 and Smax; a window
    # (the split follows the window's span: 27 blocks)
    (1, 25, 5, 64, 65536, [65536], 0),
    (3, 25, 5, 64, 65536, [0, 1, 65536], 0),
    (2, 15, 5, 64, 65536, [65536, 50000], 40000),
    # G 13 and 16 in one block, G 1, D 128, and the 4-byte paths (D 20, D
    # 100), each past 8 blocks
    (3, 13, 1, 64, 40000, [40000, 1, 0], 0),
    (2, 16, 1, 64, 40000, [40000, 1000], 0),
    (1, 4, 4, 64, 65536, [60000], 0),
    (1, 8, 1, 128, 65536, [65536], 0),
    (2, 6, 2, 20, 40000, [40000, 7], 0),
    (1, 8, 1, 100, 40000, [40000], 0),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_kernel(dev, case):
    B, Hq, Hkv, D, Smax, lengths, window = case
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn((B, 1, Hq, D), gen, dev)
    k = _randn((B, Smax, Hkv, D), gen, dev)
    v = _randn((B, Smax, Hkv, D), gen, dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = decode_attention_op.launches
    got = decode_attention_op(q, k, v, ln, window=window)
    torch.cuda.synchronize()
    assert decode_attention_op.launches == before + 1
    _close(got, decode_attention_ref(q, k, v, ln, window=window),
           BF16_ULP, 3 * BF16_ULP)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].float().any()


# (B, Sq, Sk, Hq, Hkv, D, kv_valid, window, q_offset, q_block, k_block):
# the prompts long enough that N(0, 1) outputs fall below the tolerance,
# and the last context-parallel rank's 512 rows of a 2048-token prompt
LONG_PREFILL_CASES = [
    (1, 8192, 8192, 15, 5, 64, None, 0, None, 512, 1024),
    (1, 4096, 4096, 15, 5, 64, [4001], 0, None, 512, 1024),
    (2, 6000, 6000, 15, 5, 64, [6000, 4000], 1000, None, 1000, 1000),
    (2, 512, 2048, 15, 5, 64, None, 0, 1536, 512, 1024),
]

PREFILL_CASES = [
    # (B, Sq, Sk, Hq, Hkv, D, kv_valid, window, q_offset, q_block, k_block)
    (2, 16, 16, 4, 2, 32, [16, 11], 0, None, 512, 1024),
    (3, 24, 24, 6, 2, 64, [24, 7, 0], 0, None, 512, 1024),   # kv_valid 0
    (2, 32, 32, 6, 2, 32, [32, 20], 8, None, 8, 16),         # window, blocks
    (2, 8, 32, 4, 2, 64, [32, 30], 0, 24, 512, 1024),        # q_offset
    (1, 16, 16, 4, 1, 128, None, 0, None, 4, 8),             # no kv_valid
    (8, 256, 256, 15, 5, 64, [256, 200, 129, 256, 131, 140, 250, 180], 0,
     None, 512, 1024),
    (2, 100, 100, 15, 5, 64, [100, 70], 0, None, 100, 100),  # ragged tiles
    (2, 40, 40, 4, 4, 64, [40, 23], 0, None, 512, 1024),     # G = 1
    (2, 50, 50, 16, 2, 64, [50, 31], 0, None, 512, 1024),    # G = 8
    (1, 37, 37, 6, 2, 128, [30], 0, None, 512, 1024),        # Sq*G = 111
    # q_offset > 0, window narrower than a 64-key tile; sample 1 has no
    # key inside any row's window (the mean-of-V rows)
    (2, 16, 200, 15, 5, 64, [200, 150], 24, 184, 512, 1024),
    (4, 1024, 1024, 15, 5, 64, [1024, 0, 517, 1000], 0, None, 512, 1024),
    # D = 16, the scenario model's head_dim (4 / 2 heads): its prefill
    # batches, then up to its max_len, ragged, windowed, with an offset
    (1, 8, 8, 4, 2, 16, [8], 0, None, 512, 1024),
    (2, 8, 8, 4, 2, 16, [8, 5], 0, None, 512, 1024),
    (4, 64, 64, 4, 2, 16, [64, 33, 0, 17], 0, None, 512, 1024),
    (3, 48, 48, 4, 2, 16, [48, 29, 3], 8, None, 8, 16),
    (2, 16, 64, 4, 2, 16, [64, 50], 0, 48, 512, 1024),
    # hymba: 25 / 5 heads, a ragged rung-2048 batch with the window 2048 not
    # yet binding, and the exact 3072-token prompt where it binds; reduced
    # (window 16) on its exact 24-token prompt
    (2, 2048, 2048, 25, 5, 64, [2048, 1030], 2048, None, 512, 1024),
    (1, 3072, 3072, 25, 5, 64, None, 2048, None, 512, 1024),
    (2, 24, 24, 4, 2, 16, None, 16, None, 512, 1024),
    # context-parallel prefill: one rank's 512 query rows of a 2048-token
    # prompt (smollm's 15 / 5 heads of 64) at each of 4 ranks' offsets
    *[(2, 512, 2048, 15, 5, 64, None, 0, off, 512, 1024)
      for off in (0, 512, 1024, 1536)],
    # the wgmma instance's long rows: an 8,192-token prompt, kv_valid
    # ending inside a key tile, a binding window, Sq * G off the 128-row M
    # tile, and D 16 / 32 / 128 at G 13 / 6 / 1
    *LONG_PREFILL_CASES[:3],
    (2, 300, 300, 15, 5, 64, [300, 211], 0, None, 512, 1024),
    (2, 512, 512, 13, 1, 16, [512, 300], 0, None, 512, 1024),
    (2, 600, 600, 6, 1, 32, [600, 431], 0, None, 600, 600),
    (1, 700, 700, 4, 4, 128, None, 0, None, 700, 700),
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_flash_attention_kernel(dev, case):
    B, Sq, Sk, Hq, Hkv, D, kvv, window, q_off, qb, kb = case
    gen = torch.Generator(device=dev).manual_seed(2)
    q = _randn((B, Sq, Hq, D), gen, dev)
    k = _randn((B, Sk, Hkv, D), gen, dev)
    v = _randn((B, Sk, Hkv, D), gen, dev)
    kv = None if kvv is None else torch.tensor(kvv, dtype=torch.int32,
                                               device=dev)
    kw = dict(causal=True, window=window, q_block=qb, k_block=kb,
              q_offset=q_off, kv_valid=kv)
    before = flash_attention_op.launches
    got = flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_op.launches == before + 1
    _close(got, flash_attention_ref(q, k, v, **kw), BF16_ULP, 3 * BF16_ULP)


NONCAUSAL_CASES = [
    # (B, Sq, Sk, Hq, Hkv, D, kv_valid, q_block, k_block): encoders (Sq ==
    # Sk) and cross-attention over a memory (Sq != Sk); seamless-m4t-medium
    # at full width: its encoder (B 8, S 1024, 16 / 16 heads of 64) and its
    # decoder's cross-attention (Sq 128 against Sk 1024)
    (2, 16, 16, 4, 4, 16, None, 512, 1024),
    (3, 32, 32, 4, 2, 64, None, 8, 16),
    (2, 8, 32, 4, 4, 64, None, 8, 1024),
    (3, 16, 8, 4, 2, 32, None, 16, 1024),
    (2, 24, 48, 6, 2, 128, [48, 30], 8, 16),
    (2, 100, 60, 15, 5, 64, None, 100, 60),                  # ragged tiles
    (8, 1024, 1024, 16, 16, 64, None, 512, 1024),
    (8, 128, 1024, 16, 16, 64, None, 128, 1024),
    (8, 128, 512, 16, 16, 64, None, 128, 1024),
    # the wgmma instance at D 16 / 32 / 128, G 13 / 6 / 1, kv_valid
    (2, 600, 900, 13, 1, 16, [900, 500], 600, 900),
    (2, 300, 700, 6, 1, 32, None, 300, 700),
    (2, 256, 512, 4, 4, 128, [512, 333], 256, 512),
]


@pytest.mark.parametrize("case", NONCAUSAL_CASES)
def test_flash_attention_kernel_noncausal(dev, case):
    B, Sq, Sk, Hq, Hkv, D, kvv, qb, kb = case
    gen = torch.Generator(device=dev).manual_seed(6)
    q = _randn((B, Sq, Hq, D), gen, dev)
    k = _randn((B, Sk, Hkv, D), gen, dev)
    v = _randn((B, Sk, Hkv, D), gen, dev)
    kv = None if kvv is None else torch.tensor(kvv, dtype=torch.int32,
                                               device=dev)
    kw = dict(causal=False, q_block=qb, k_block=kb, kv_valid=kv)
    before = flash_attention_op.launches
    got = flash_attention_op(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_op.launches == before + 1
    _close(got, flash_attention_ref(q, k, v, **kw), BF16_ULP, 3 * BF16_ULP)


@pytest.mark.parametrize("case", LONG_PREFILL_CASES)
def test_flash_attention_kernel_on_planted_keys(dev, case):
    """On N(0, 1) inputs a long prompt's outputs are mostly below the
    absolute tolerance, so a lost key tile would pass there. On
    ``probe.planted`` inputs (a key every head scores far above the rest at
    every 64th position) each loaded key tile moves its rows' outputs by
    several tolerances: the kernel agrees with the plain version under the
    same tolerance, and each ``probe.faults`` output (a lost first, middle,
    last-before-diagonal or diagonal tile of a block's rows, zeros) fails
    it."""
    from repro_torch.kernels.flash_attention import probe
    B, Sq, Sk, Hq, Hkv, D, kvv, window, q_off, qb, kb = case
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v = probe.planted(gen, B, Sq, Sk, Hq, Hkv, D, dev)
    kv = None if kvv is None else torch.tensor(kvv, dtype=torch.int32,
                                               device=dev)
    kw = dict(causal=True, window=window, q_offset=q_off, kv_valid=kv)
    got = flash_attention_op(q, k, v, q_block=qb, k_block=kb, **kw)
    want = flash_attention_ref(q, k, v, q_block=qb, k_block=kb, **kw)
    _close(got, want, BF16_ULP, 3 * BF16_ULP)
    faults = list(probe.faults(q, k, v, want, **kw))
    assert len(faults) == 5
    for name, bad in faults:
        with pytest.raises(AssertionError):
            _close(bad, want, BF16_ULP, 3 * BF16_ULP)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D", [
    (1, 4096, 4096, 15, 5, 64),      # the wgmma instance, 480 items
    (8, 128, 128, 7, 1, 64)])        # the mma instance (a TP rank's rung)
def test_flash_attention_is_bit_equal_run_to_run_and_in_a_graph(
        dev, B, Sq, Sk, Hq, Hkv, D):
    """Each output row is summed by one block in one order, with no split
    over keys and no atomics: two launches on the same inputs, and the
    launch captured in a CUDA graph and replayed (also after the inputs
    change in place), give the same bits as an eager call. One count a
    call."""
    gen = torch.Generator(device=dev).manual_seed(9)
    q = _randn((B, Sq, Hq, D), gen, dev)
    k = _randn((B, Sk, Hkv, D), gen, dev)
    v = _randn((B, Sk, Hkv, D), gen, dev)
    kv = torch.tensor([Sk - 37 * i for i in range(B)], dtype=torch.int32,
                      device=dev)
    calls = flash_attention_op.launches
    first = flash_attention_op(q, k, v, kv_valid=kv)
    second = flash_attention_op(q, k, v, kv_valid=kv)
    torch.cuda.synchronize()
    assert flash_attention_op.launches == calls + 2
    assert torch.equal(first, second)
    _close(first, flash_attention_ref(q, k, v, kv_valid=kv), BF16_ULP,
           3 * BF16_ULP)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_op(q, k, v, kv_valid=kv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash_attention_op(q, k, v, kv_valid=kv)
    for step in range(2):
        if step:
            k.mul_(0.5)
            v.add_(1.0)
            kv.copy_(torch.tensor([Sk - 100 * i - 1 for i in range(B)],
                                  dtype=torch.int32, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        eager = flash_attention_op(q, k, v, kv_valid=kv)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_kernel_on_planted_keys(dev, case):
    """On N(0, 1) inputs a long cache's output is below the absolute
    tolerance, so a lost block would pass there. On ``probe.planted``
    inputs (a key every head scores far above the rest at the first and
    last position of each slice of the wrapper's split) every slice moves
    the output by several tolerances: the kernel agrees with the plain
    version under the same tolerance, and each ``probe.faults`` output (a
    lost slice, a lost first or last tile, zeros) fails it."""
    from repro_torch.kernels.decode_attention import probe
    from repro_torch.kernels.decode_attention.decode_attention import splits
    B, Hq, Hkv, D, Smax, lengths, window = case
    p = splits(B, Hkv, D, Smax, window)
    gen = torch.Generator(device=dev).manual_seed(31)
    q, k, v, ln = probe.planted(gen, B, Hq, Hkv, D, Smax, window, lengths,
                                p, dev)
    got = decode_attention_op(q, k, v, ln, window=window)
    want = decode_attention_ref(q, k, v, ln, window=window)
    _close(got, want, BF16_ULP, 3 * BF16_ULP)
    for name, bad in probe.faults(q, k, v, ln, window, p):
        with pytest.raises(AssertionError):
            _close(bad, want, BF16_ULP, 3 * BF16_ULP)


@pytest.mark.parametrize("B,Hq,Hkv,D,Smax", [
    (8, 15, 5, 64, 256),         # one cluster of 8 blocks
    (8, 10, 2, 64, 40960)])      # 17 blocks, a workspace and a second launch
def test_decode_attention_replays_in_a_cuda_graph(dev, B, Hq, Hkv, D, Smax):
    """The launch (the cluster's, or the split's and its merge's) captured
    in a CUDA graph replays to the eager output, also after the inputs
    change in place. Same kernel, same inputs, a fixed merge order and no
    atomics: equal bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _randn((B, 1, Hq, D), gen, dev)
    k = _randn((B, Smax, Hkv, D), gen, dev)
    v = _randn((B, Smax, Hkv, D), gen, dev)
    ln = torch.tensor([0, 1, 37, 128, 200, 255, 256, 64], dtype=torch.int32,
                      device=dev) * (Smax // 256)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_op(q, k, v, ln)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention_op(q, k, v, ln)
    for step in range(2):
        if step:
            k.mul_(0.5)
            v.add_(1.0)
            ln.copy_(torch.tensor([256, 3, 0, 129, 17, 250, 1, 64],
                                  dtype=torch.int32, device=dev)
                     * (Smax // 256))
        graph.replay()
        torch.cuda.synchronize()
        eager = decode_attention_op(q, k, v, ln)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        _close(captured, decode_attention_ref(q, k, v, ln), BF16_ULP,
               3 * BF16_ULP)


def test_decode_attention_split_merge_is_bit_equal_run_to_run(dev):
    """Past 8 blocks a (kv head, sample) the partials go through a
    workspace and a second launch; both merge in a fixed order, so two
    launches on the same inputs give the same bits. The wrapper counts
    each call once in ``launches`` and its two CUDA launches in
    ``cuda_launches``."""
    from repro_torch.kernels.decode_attention.decode_attention import (
        MAX_CLUSTER, splits)
    B, Hq, Hkv, D, Smax = 2, 25, 5, 64, 131072
    assert splits(B, Hkv, D, Smax, 0) > MAX_CLUSTER
    gen = torch.Generator(device=dev).manual_seed(8)
    q = _randn((B, 1, Hq, D), gen, dev)
    k = _randn((B, Smax, Hkv, D), gen, dev)
    v = _randn((B, Smax, Hkv, D), gen, dev)
    ln = torch.tensor([Smax, 77777], dtype=torch.int32, device=dev)
    calls = decode_attention_op.launches
    cuda = decode_attention_op.cuda_launches
    first = decode_attention_op(q, k, v, ln)
    second = decode_attention_op(q, k, v, ln)
    torch.cuda.synchronize()
    assert decode_attention_op.launches == calls + 2
    assert decode_attention_op.cuda_launches == cuda + 4
    assert torch.equal(first, second)
    _close(first, decode_attention_ref(q, k, v, ln), BF16_ULP, 3 * BF16_ULP)


@pytest.mark.parametrize("D", [64, 20])
def test_decode_attention_cache_off_sixteen_bytes(dev, D):
    """K and V that start 4 bytes past a 16-byte boundary take the 4-byte
    copies (as D % 8 != 0 does) and agree with the plain version; 2 bytes
    past one, no copy the kernel has fits, and the call raises."""
    B, Hq, Hkv, Smax = 2, 10, 2, 300
    gen = torch.Generator(device=dev).manual_seed(9)
    q = _randn((B, 1, Hq, D), gen, dev)
    ln = torch.tensor([300, 41], dtype=torch.int32, device=dev)
    n = B * Smax * Hkv * D
    for off in (2, 1):
        k = _randn((n + off,), gen, dev)[off:].view(B, Smax, Hkv, D)
        v = _randn((n + off,), gen, dev)[off:].view(B, Smax, Hkv, D)
        if off == 1:
            with pytest.raises(RuntimeError, match="cudaError_t"):
                decode_attention_op(q, k, v, ln)
            continue
        got = decode_attention_op(q, k, v, ln)
        torch.cuda.synchronize()
        _close(got, decode_attention_ref(q, k, v, ln), BF16_ULP,
               3 * BF16_ULP)


SCAN_CASES = [
    # (B, S, H, dk, dv, chunk, initial state)
    (2, 16, 3, 16, 8, 8, True),          # two chunks
    (1, 8, 2, 32, 1, 256, False),        # dv = 1 (the normalizer), S < chunk
    (2, 64, 2, 32, 40, 32, True),        # a ragged state-column tile
    (3, 40, 2, 20, 33, 40, True),        # W not a multiple of 32, dk % 8 = 4
    (8, 256, 4, 384, 384, 256, False),   # full width, the memory alone
    (8, 256, 4, 384, 385, 256, False),   # the mLSTM's launch: v ‖ ones
    (2, 512, 4, 384, 1, 256, True),      # two full-width chunks, dv = 1
    (2, 64, 2, 16, 64, 64, True),        # dk = 16 (hymba's ssm_state)
    (2, 96, 2, 100, 48, 32, True),       # dk = 100: not a micro-tile multiple
    (2, 400, 2, 384, 96, 200, True),     # chunk 200: a ragged row tile
    (2, 512, 4, 384, 385, 64, True),     # 8 chunks of 64, the mLSTM's dv
    (2, 512, 25, 16, 64, 256, True),     # hymba: ssm_state 16, head_dim 64
    (3, 24, 4, 8, 16, 8, True),          # reduced hymba, 3 chunks
    (1, 1024, 2, 16, 64, 512, True),     # dk = 16 in chunks of 512: serial
]


def _scan_inputs(B, S, H, dk, dv, state, gen, dev):
    """q, k scaled by dk**-0.5 as the mLSTM scales them, sigmoid gates as
    it makes them, with the second half of sample 0 right-padded."""
    q = _randn((B, S, H, dk), gen, dev, dk ** -0.5)
    k = _randn((B, S, H, dk), gen, dev, dk ** -0.5)
    v = _randn((B, S, H, dv), gen, dev)
    raw = torch.randn((2, B, S, H), generator=gen, device=dev)
    log_f = torch.nn.functional.logsigmoid(raw[0] + 4.0)
    log_i = torch.nn.functional.logsigmoid(raw[1])
    log_f[0, S // 2:], log_i[0, S // 2:] = 0.0, -1e30
    s0 = (torch.randn((B, H, dk, dv), generator=gen, device=dev)
          if state else None)
    return q, k, v, log_f.contiguous(), log_i.contiguous(), s0


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_scan_kernel(dev, case):
    """Kernel against the plain version on the same card inputs: both sum
    fp32 products of up to dk (q . k, q . S) or a chunk (P v, k^T v) terms
    in other orders, so y to one bf16 rounding plus 2e-5 of its largest
    magnitude, the fp32 state to rtol 2e-5 plus 2e-5 of its largest."""
    B, S, H, dk, dv, chunk, state = case
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, lf, li, s0 = _scan_inputs(B, S, H, dk, dv, state, gen, dev)
    before = ssd_scan_op.launches
    y, st = ssd_scan_op(q, k, v, lf, li, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert ssd_scan_op.launches == before + 1
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=chunk, initial_state=s0)
    _close(y, yr, BF16_ULP, 2e-5 * float(yr.float().abs().max()))
    _close(st, sr, 2e-5, 2e-5 * float(sr.abs().max()))


def test_ssd_scan_replays_in_a_cuda_graph(dev):
    """The scan captured in a CUDA graph replays to the eager output, also
    after the inputs change in place. Same kernel, same inputs, a fixed
    order of every sum and no atomics: equal bit for bit."""
    B, S, H, dk, dv, chunk = 2, 128, 2, 64, 65, 64
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v, lf, li, s0 = _scan_inputs(B, S, H, dk, dv, True, gen, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan_op(q, k, v, lf, li, chunk=chunk, initial_state=s0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ssd_scan_op(q, k, v, lf, li, chunk=chunk,
                               initial_state=s0)
    for step in range(2):
        if step:
            k.mul_(0.5)
            v.add_(1.0)
            s0.mul_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        eager = ssd_scan_op(q, k, v, lf, li, chunk=chunk, initial_state=s0)
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
        yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=chunk, initial_state=s0)
        _close(captured[0], yr, BF16_ULP, 2e-5 * float(yr.float().abs().max()))
        _close(captured[1], sr, 2e-5, 2e-5 * float(sr.abs().max()))


# the chunked instance (dk <= 32): hymba's four rows (rung 2048 from a
# carried state, the exact 3,072 prompt, the tensor-parallel ranks' rung 128
# at 7 and 13 heads) and its ragged edges: dk 1, 16 and 20 (and 32); dv 1,
# 63, 64 and 65; 1, 2 and 12 chunks; a chunk of 200 (a ragged row tile);
# (B, S, H, dk, dv, chunk, padded lengths or None, initial state)
CHUNKED_CASES = [
    (8, 2048, 25, 16, 64, 256,
     [2048, 1600, 1030, 2048, 600, 1280, 2040, 2035], True),
    (1, 3072, 25, 16, 64, 256, None, False),
    (8, 128, 7, 16, 64, 256, [32, 64, 128, 32, 64, 128, 32, 64], False),
    (8, 128, 13, 16, 64, 256, [32, 64, 128, 128, 32, 64, 128, 128], False),
    (2, 512, 3, 1, 64, 256, [512, 300], True),
    (2, 256, 3, 16, 1, 256, None, True),
    (1, 3072, 2, 20, 63, 256, None, True),
    (2, 512, 3, 20, 65, 256, [512, 77], True),
    (3, 600, 2, 32, 64, 200, [600, 599, 1], True),
    (2, 64, 2, 16, 63, 64, None, False),
    (1, 8, 2, 16, 64, 256, None, True),
]


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_ssd_scan_chunked_instance(dev, case):
    """The chunked instance against the plain version under hymba's gates
    (softplus dt), pad-masked where lengths are given, with the tolerances
    of ``test_ssd_scan_kernel``."""
    from repro_torch.kernels.ssd_scan.ssd_scan import CHUNKED, geometry
    from repro_torch.models.linear_core import pad_mask_gates
    B, S, H, dk, dv, chunk, lens, state = case
    W = min(chunk, S)
    assert geometry(B, H, dk, dv, W, S // W).instance == CHUNKED
    gen = torch.Generator(device=dev).manual_seed(17)
    q, k = (_randn((B, S, H, dk), gen, dev) for _ in range(2))
    v = _randn((B, S, H, dv), gen, dev)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=dev))
    lf, li = -dt, torch.log(dt)
    if lens is not None:
        lf, li = pad_mask_gates(lf, li, torch.tensor(lens, dtype=torch.int32,
                                                     device=dev))
    s0 = (torch.randn((B, H, dk, dv), generator=gen, device=dev) if state
          else None)
    before = ssd_scan_op.launches
    y, st = ssd_scan_op(q, k, v, lf, li, chunk=chunk, initial_state=s0)
    torch.cuda.synchronize()
    assert ssd_scan_op.launches == before + 1
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=chunk, initial_state=s0)
    _close(y, yr, BF16_ULP, 2e-5 * float(yr.float().abs().max()))
    _close(st, sr, 2e-5, 2e-5 * float(sr.abs().max()))


@pytest.mark.parametrize("B,S,H,lens,state", [
    (8, 2048, 25, [2048, 1600, 1030, 2048, 600, 1280, 2040, 2035], True),
    (1, 3072, 25, None, False),
    (2, 1024, 3, [1024, 700], True)])
def test_ssd_scan_planted_probe(dev, B, S, H, lens, state):
    """On ``probe.planted`` inputs (slow gates, every chunk owning a column
    of the final state and of the later chunks' y) the kernel passes the
    check and each of ``probe.faults``'s outputs fails it."""
    from repro_torch.kernels.ssd_scan import probe
    from repro_torch.models.linear_core import pad_mask_gates
    gen = torch.Generator(device=dev).manual_seed(37)
    q, k, v, lf, li = probe.planted(gen, B, S, H, 16, 64, 256, dev)
    if lens is not None:
        lf, li = pad_mask_gates(lf, li, torch.tensor(lens, dtype=torch.int32,
                                                     device=dev))
    s0 = (torch.randn((B, H, 16, 64), generator=gen, device=dev) if state
          else None)
    y, st = ssd_scan_op(q, k, v, lf, li, chunk=256, initial_state=s0)
    yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=256, initial_state=s0)
    _close(y, yr, BF16_ULP, 2e-5 * float(yr.float().abs().max()))
    _close(st, sr, 2e-5, 2e-5 * float(sr.abs().max()))
    caught = 0
    for name, fy, fs in probe.faults(q, k, v, lf, li, chunk=256,
                                     initial_state=s0):
        with pytest.raises(AssertionError):
            _close(fy, yr, BF16_ULP, 2e-5 * float(yr.float().abs().max()))
            _close(fs, sr, 2e-5, 2e-5 * float(sr.abs().max()))
        caught += 1
    assert caught == 6


@pytest.mark.parametrize("S", [256, 1024])
def test_ssd_scan_chunked_replays_in_a_cuda_graph(dev, S):
    """The chunked instance (its workspace allocated inside the capture,
    two or three launches) captured in a CUDA graph replays to the eager
    output bit for bit, also after the inputs change in place."""
    B, H, dk, dv, chunk = 2, 3, 16, 64, 256
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v, lf, li, s0 = _scan_inputs(B, S, H, dk, dv, True, gen, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan_op(q, k, v, lf, li, chunk=chunk, initial_state=s0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ssd_scan_op(q, k, v, lf, li, chunk=chunk,
                               initial_state=s0)
    for step in range(2):
        if step:
            k.mul_(0.5)
            v.add_(1.0)
            s0.mul_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        eager = ssd_scan_op(q, k, v, lf, li, chunk=chunk, initial_state=s0)
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
        yr, sr = ssd_scan_ref(q, k, v, lf, li, chunk=chunk, initial_state=s0)
        _close(captured[0], yr, BF16_ULP, 2e-5 * float(yr.float().abs().max()))
        _close(captured[1], sr, 2e-5, 2e-5 * float(sr.abs().max()))


def test_wrappers_raise_on_unsupported_card_inputs(dev):
    q = torch.zeros((1, 1, 4, 64), device=dev, dtype=torch.float32)
    kv = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float32)
    ln = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):                   # fp32: no kernel, no fallback
        decode_attention_op(q, kv, kv, ln)
    with pytest.raises(ValueError, match="G <= 16"):  # 17 heads a kv head
        decode_attention_op(torch.zeros((1, 1, 17, 64), device=dev,
                                        dtype=torch.bfloat16),
                            kv[:, :, :1].to(torch.bfloat16).contiguous(),
                            kv[:, :, :1].to(torch.bfloat16).contiguous(), ln)
    x32 = torch.zeros((8, 64), device=dev)
    with pytest.raises(TypeError):                   # fp32 x and weight
        rmsnorm_op(x32, torch.ones(64, device=dev))
    with pytest.raises(TypeError):                   # bf16 x, fp32 weight
        rmsnorm_op(x32.bfloat16(), torch.ones(64, device=dev))
    with pytest.raises(ValueError):                  # wider than 8 warps hold
        rmsnorm_op(torch.zeros((2, 16392), dtype=torch.bfloat16, device=dev),
                   torch.ones(16392, dtype=torch.bfloat16, device=dev))
    with pytest.raises(TypeError):
        flash_attention_op(q, kv, kv)
    qb = torch.zeros((1, 1, 4, 48), device=dev, dtype=torch.bfloat16)
    kb = torch.zeros((1, 8, 2, 48), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # D = 48: not compiled
        flash_attention_op(qb, kb, kb)
    z = torch.zeros((1, 8, 2, 16), device=dev, dtype=torch.bfloat16)
    g = torch.zeros((1, 8, 2), device=dev)
    with pytest.raises(TypeError):                   # fp32 q, k, v
        ssd_scan_op(z.float(), z.float(), z.float(), g, g)
    with pytest.raises(TypeError):                   # bf16 gates
        ssd_scan_op(z, z, z, g.bfloat16(), g.bfloat16())
    zk = torch.zeros((1, 8, 2, 520), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # dk > 512
        ssd_scan_op(zk, zk, z, g, g)
    with pytest.raises(ValueError):                  # S % chunk
        ssd_scan_op(z, z, z, g, g, chunk=3)


@pytest.mark.parametrize("heads", [(4, 2), (6, 2)])
def test_lmserver_on_card_runs_every_kernel(dev, heads):
    """A small dense model served on the card: every kernel launches, every
    request completes, and the prefill logits match the CPU plain path on
    the same weights (two layers of bf16 rounding in other orders: within
    5 % of the largest logit)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import LMServer

    nq, nkv = heads
    cfg = dataclasses.replace(reduced_config(ARCHITECTURES["smollm-360m"]),
                              num_heads=nq, num_kv_heads=nkv, head_dim=32,
                              d_model=32 * nq, d_ff=64 * nq)
    cpu = build_model(cfg, device="cpu")
    cpu_params = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev)

    card_params = _tree_to(cpu_params, dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 24)).astype(np.int32)
    lens = np.array([24, 17, 5], np.int32)
    logits = []
    for model, params, d in ((cpu, cpu_params, "cpu"),
                             (card, card_params, dev)):
        out, _ = model.prefill(params, {
            "tokens": torch.from_numpy(toks).to(d),
            "lengths": torch.from_numpy(lens).to(d)}, max_len=64)
        logits.append(out.float().cpu())
    scale = logits[0].abs().max()
    assert (logits[1] - logits[0]).abs().max() <= 0.05 * scale

    ops = (rmsnorm_op, decode_attention_op, flash_attention_op)
    before = [op.launches for op in ops]
    srv = LMServer(card, device=dev, slots=4, max_len=64)
    rids = [srv.submit(rng.integers(0, cfg.vocab_size, size=int(n)),
                       max_new_tokens=6) for n in (3, 9, 17, 30, 12)]
    srv.run(card_params)
    assert all(len(srv.completed[r].tokens) == 6 for r in rids)
    assert all(op.launches > b for op, b in zip(ops, before))
    assert srv.stats["host_syncs_per_decode_step"] == 1.0


def test_xlstm_lmserver_on_card(dev):
    """Reduced xlstm served on the card: ssd_scan and rmsnorm launch, every
    request completes, and prefill logits and every state leaf match the
    CPU plain path on the same weights (bf16 rounding in other orders
    through one pair: logits within 5 % of the largest, states within 1 %
    of the leaf's largest magnitude)."""
    import numpy as np

    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import LMServer

    cfg = reduced_config(ARCHITECTURES["xlstm-125m"])
    cpu = build_model(cfg, device="cpu", chunk=8)
    cpu_params = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev, chunk=8)

    card_params = _tree_to(cpu_params, dev)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 24)).astype(np.int32)
    lens = np.array([24, 17, 5], np.int32)
    outs = []
    for model, params, d in ((cpu, cpu_params, "cpu"),
                             (card, card_params, dev)):
        logits, cache = model.prefill(params, {
            "tokens": torch.from_numpy(toks).to(d),
            "lengths": torch.from_numpy(lens).to(d)})
        leaves = [cache["m"][0], cache["m"][1], *cache["s"]]
        outs.append([logits.float().cpu()] + [t.cpu() for t in leaves])
    for i, (a, b) in enumerate(zip(*outs)):
        tol = 0.05 if i == 0 else 0.01
        assert (b - a).abs().max() <= tol * a.abs().max(), i

    ops = (rmsnorm_op, ssd_scan_op)
    before = [op.launches for op in ops]
    srv = LMServer(card, device=dev, slots=4, max_len=64)
    rids = [srv.submit(rng.integers(0, cfg.vocab_size, size=int(n)),
                       max_new_tokens=6) for n in (3, 9, 17, 30, 12)]
    srv.run(card_params)
    assert all(len(srv.completed[r].tokens) == 6 for r in rids)
    assert all(op.launches > b for op, b in zip(ops, before))
    assert srv.stats["host_syncs_per_decode_step"] == 1.0


def test_hymba_lmserver_on_card(dev):
    """Reduced hymba served on the card: all four kernels launch, every
    request completes (prompts past the window of 16 take the exact path,
    decoding past it wraps the rings), the decode step replays from its
    graph, and prefill logits and every cache leaf match the CPU plain path
    on the same weights (bf16 rounding in other orders through two layers:
    logits within 5 % of the largest; leaves within 5 % of the leaf's
    largest magnitude, about twice the largest seen on an H100, 2.5 % of
    an SSD state, where a flipped input enters scaled by the input gate)."""
    import numpy as np

    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import LMServer

    cfg = reduced_config(ARCHITECTURES["hymba-1.5b"])
    cpu = build_model(cfg, device="cpu")
    cpu_params = cpu.init(torch.Generator().manual_seed(0))
    card = build_model(cfg, device=dev)

    card_params = _tree_to(cpu_params, dev)
    rng = np.random.default_rng(0)
    for S, lens in ((16, [16, 11, 5]), (24, None)):
        toks = rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
        outs = []
        for model, params, d in ((cpu, cpu_params, "cpu"),
                                 (card, card_params, dev)):
            batch = {"tokens": torch.from_numpy(toks).to(d)}
            if lens is not None:
                batch["lengths"] = torch.tensor(lens, dtype=torch.int32,
                                                device=d)
            logits, cache = model.prefill(params, batch, max_len=48)
            outs.append([logits.float().cpu()] + [
                cache[k].float().cpu() for k in sorted(cache)
                if k != "lengths"])
        for i, (a, b) in enumerate(zip(*outs)):
            assert (b - a).abs().max() <= 0.05 * a.abs().max(), (S, i)

    ops = (rmsnorm_op, decode_attention_op, flash_attention_op, ssd_scan_op)
    before = [op.launches for op in ops]
    srv = LMServer(card, device=dev, slots=4, max_len=64)
    lengths = (3, 9, 17, 30, 12, 16)
    rids = [srv.submit(rng.integers(0, cfg.vocab_size, size=n),
                       max_new_tokens=12) for n in lengths]
    srv.run(card_params)
    assert all(len(srv.completed[r].tokens) == 12 for r in rids)
    assert all(op.launches > b for op, b in zip(ops, before))
    assert srv.graph_replays == srv.decode_steps - 1
    assert srv.stats["host_syncs_per_decode_step"] == 1.0


# ---------------------------------------------------------------------------
# the fused decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _small_model(kind, dev):
    """A reduced dense model (G = 2, D = 32: shapes every kernel takes),
    reduced xlstm (chunk 8) or reduced hymba (window 16: prompts past it
    take the exact path, and decoding past it wraps the rings), or reduced
    internvl2-1b, dbrx-132b (4 experts, top-2) or seamless-m4t-medium, with
    seeded weights on the card."""
    import dataclasses

    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    from repro_torch.models.api import build_model

    if kind == "dense":
        cfg = dataclasses.replace(
            reduced_config(ARCHITECTURES["smollm-360m"]), num_heads=4,
            num_kv_heads=2, head_dim=32, d_model=128, d_ff=256)
        model = build_model(cfg, device=dev)
    elif kind == "hymba":
        model = build_model(reduced_config(ARCHITECTURES["hymba-1.5b"]),
                            device=dev)
    elif kind in ("vlm", "moe", "encdec"):
        arch = {"vlm": "internvl2-1b", "moe": "dbrx-132b",
                "encdec": "seamless-m4t-medium"}[kind]
        model = build_model(reduced_config(ARCHITECTURES[arch]), device=dev)
    else:
        model = build_model(reduced_config(ARCHITECTURES["xlstm-125m"]),
                            device=dev, chunk=8)
    return model


def _params(model, seed):
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def _server(model, *, graph, temperature=0.0, seed=0, **kw):
    """An LMServer in calibrated-simulation mode (admission decisions do
    not depend on wall time). ``graph=False`` runs every fused step and
    every ladder prefill eagerly, the work the graphs capture."""
    from repro_torch.core.metrics import VirtualClock
    from repro_torch.serving.engine import LMServer

    srv = LMServer(model, device=model.device, slots=4, max_len=64,
                   temperature=temperature, seed=seed, clock=VirtualClock(),
                   service_model=lambda kind, b, t: 1e-3 * (1 + b * t), **kw)
    if not graph:
        srv._decode_device = lambda params: srv._decode_fused(
            params, *srv._slot_state())
        _eager_prefill(srv)
    return srv


def _eager_prefill(srv):
    """Make ``srv`` run every ladder prefill eagerly, the work its prefill
    graphs capture."""
    dev = srv.device
    srv._prefill_graphed = lambda params, toks, vlens: srv.model.prefill(
        params, {"tokens": torch.from_numpy(toks).to(dev),
                 "lengths": torch.from_numpy(vlens).to(dev)},
        max_len=srv.max_len)


def _serve(srv, params, prompts_seed=0, n=6, max_new=8):
    """Submit ``n`` prompts of 3-30 tokens and run; returns the streams and
    each kernel wrapper's launches during the run."""
    import numpy as np

    from repro_torch.kernels import launch_counts

    rng = np.random.default_rng(prompts_seed)
    vocab = srv.model.cfg.vocab_size
    rids = [srv.submit(rng.integers(0, vocab, size=int(k)),
                       max_new_tokens=max_new)
            for k in rng.integers(3, 31, size=n)]
    before = launch_counts()
    srv.run(params)
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(len(srv.completed[r].tokens) == max_new for r in rids)
    return ([srv.completed[r].tokens for r in rids],
            {w.__name__: after[w] - before[w] for w in after})


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("kind", ["dense", "xlstm", "hymba", "vlm", "moe"])
def test_graphed_decode_matches_eager(dev, kind, temperature):
    """The same requests through a server whose fused step replays as a
    CUDA graph and through one that runs it eagerly: the same kernels on
    the same inputs in the same order, and at temperature 0.8 the same
    generator draws (registered with the graph, advanced per replay), so
    the streams are equal bit for bit; the kernel launch counts are equal
    and one host copy is made per step."""
    model = _small_model(kind, dev)
    params = _params(model, 0)
    runs = []
    for graph in (True, False):
        srv = _server(model, graph=graph, temperature=temperature)
        runs.append(_serve(srv, params) + (srv,))
    (g_toks, g_launch, g_srv), (e_toks, e_launch, e_srv) = runs
    assert g_srv.graph_replays > 0 and g_srv.engine_report()["decode"]["graph"]
    assert e_srv.graph_replays == 0
    assert g_srv.decode_steps == e_srv.decode_steps
    assert g_toks == e_toks
    assert g_launch == e_launch
    assert g_srv.stats["host_syncs_per_decode_step"] == 1.0


def _park(model, params, batch, max_len):
    """``batch``'s prefill moved into slots 0.. of a 4-slot server by
    admission's own placement; the requests never finish on their own."""
    import numpy as np

    from repro_torch.serving.engine import Request

    srv = _server(model, graph=True)
    assert srv.max_len == max_len
    logits, pcache = model.prefill(params, batch, max_len=max_len)
    B = logits.shape[0]
    srv._place([Request(i, np.zeros(0, np.int32), 1 << 30, 0.0)
                for i in range(B)], logits, pcache, list(range(B)),
               pcache["lengths"].cpu().numpy(), None)
    return srv


@pytest.mark.parametrize("S_enc", [8, 64])
def test_encdec_graphed_decode_matches_eager_and_cpu(dev, S_enc):
    """Reduced seamless-m4t-medium through prefill (frames of S_enc rows,
    decoder prompts of 5 and 9 tokens on rung 16) -> ``batched_scatter``
    into a 64-row slot cache (8 frames: the memory padded with zero rows)
    -> the fused step, 12 steps graphed and eager: equal streams; the
    graphed streams equal the CPU's plain path's (greedy: the card may
    differ from the CPU only at a bf16 near-tie, which these inputs do not
    reach)."""
    import numpy as np

    model = _small_model("encdec", dev)
    params = _params(model, 0)
    rng = np.random.default_rng(3)
    toks = np.zeros((2, 16), np.int32)
    toks[0, :5] = rng.integers(0, 256, 5)
    toks[1, :9] = rng.integers(0, 256, 9)
    frames = rng.normal(size=(2, S_enc, model.cfg.d_model)).astype(np.float32)

    def batch(d):
        return {"tokens": torch.from_numpy(toks).to(d),
                "lengths": torch.tensor([5, 9], dtype=torch.int32, device=d),
                "frames": torch.from_numpy(frames).to(d)}

    streams = []
    from repro_torch.models.api import build_model
    cpu_model = build_model(model.cfg, device="cpu")
    for m, p, graph in ((model, params, True), (model, params, False),
                        (cpu_model, _tree_to(params, "cpu"), False)):
        srv = _park(m, p, batch(m.device), 64)
        if not graph and m.device.type == "cuda":
            srv._decode_device = lambda params, srv=srv: srv._decode_fused(
                params, *srv._slot_state())
        for _ in range(12):
            srv._decode_once(p)
        if graph:
            assert srv.graph_replays == 11
        streams.append([r.tokens for _, r in sorted(srv._active.items())])
    assert streams[0] == streams[1] == streams[2]


def test_graph_launch_counts_equal_eager(dev):
    """Each kernel's count rises by the same amount with and without the
    graph: the capture's counts are taken back and each replay credits the
    kernels it launches."""
    model = _small_model("dense", dev)
    params = _params(model, 0)
    (_, g_launch), (_, e_launch) = (
        _serve(_server(model, graph=graph), params, n=8, max_new=12)
        for graph in (True, False))
    assert g_launch == e_launch
    for name in ("rmsnorm_op", "decode_attention_op", "flash_attention_op"):
        assert g_launch[name] > 0, name


def test_new_params_tree_recaptures(dev):
    """A run with another params tree must not replay the graph that reads
    the old weights: the server starts over (eager, then a new capture),
    and every stream equals the eager server's on the same sequence."""
    model = _small_model("dense", dev)
    p0, p1 = _params(model, 0), _params(model, 1)
    streams = []
    for graph in (True, False):
        srv = _server(model, graph=graph)
        first = _serve(srv, p0, prompts_seed=0)[0]
        g0 = srv._graph
        second = _serve(srv, p1, prompts_seed=1)[0]
        if graph:
            assert g0 is not None and srv._graph is not None
            assert srv._graph is not g0
            assert srv._graph_params is p1
        streams.append((first, second))
    assert streams[0] == streams[1]


def test_capture_error_raises_without_eager_fallback(dev):
    """An error while the step is captured propagates; the next step tries
    the capture again and raises again: no step runs eagerly in its place,
    and the failed capture leaves the launch counts as they were."""
    import numpy as np

    from repro_torch.kernels import launch_counts

    model = _small_model("dense", dev)
    params = _params(model, 0)
    srv = _server(model, graph=True)
    fused = srv._decode_fused

    def refuse_capture(*args):
        out = fused(*args)
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused during capture")
        return out

    srv._decode_fused = refuse_capture
    rng = np.random.default_rng(0)
    srv.submit(rng.integers(0, model.cfg.vocab_size, size=9),
               max_new_tokens=8)
    srv.step(params)                        # admission and the eager step
    assert srv.decode_steps == 1
    for _ in range(2):
        before = launch_counts()
        with pytest.raises(RuntimeError, match="refused during capture"):
            srv.step(params)
        assert launch_counts() == before
        assert srv.decode_steps == 1 and srv.graph_replays == 0
        assert srv._graph is None


# ---------------------------------------------------------------------------
# the ladder prefill as CUDA graphs, one a (rows, rung) shape
# ---------------------------------------------------------------------------

# prompt lengths on two length rungs a model's ladder has (the dense
# model's 64-token ladder 8, 16, 32, 64; hymba's, capped at its window of
# 16, 8 and 16), at batch rungs 1 and 2
PREFILL_RUNGS = {"dense": ((3, 8), (17, 32)), "hymba": ((3, 8), (9, 16))}


def _prefill_waves(kind, rounds=4):
    """Waves of prompt lengths, each one dispatch: the shapes (1, short
    rung), (2, long), (1, long), (2, short) in turn, ``rounds`` times, so
    that the replays of every shape sit between the other shapes' in the
    pool they share."""
    import numpy as np

    rng = np.random.default_rng(5)
    short, long_ = PREFILL_RUNGS[kind]
    out = []
    for _ in range(rounds):
        for (lo, hi), n in ((short, 1), (long_, 2), (long_, 1), (short, 2)):
            out.append([int(k) for k in rng.integers(lo, hi + 1, size=n)])
    return out


def _serve_waves(srv, params, waves, seed=0, max_new=4):
    """Serve each wave to its end (the AIMD budget at the 4 slots, so a
    wave is one dispatch). Records each dispatch's logits and, after its
    placement, every leaf of the slot cache; -> (records, the streams, the
    kernels' launches during the run)."""
    import numpy as np

    from repro_torch.core.batching import AIMDController
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import leaves

    srv.admission = AIMDController(srv.admission.slo, additive=1, init=4,
                                   max_batch=4)
    recs = []
    prefill, admit = srv._prefill, srv._admit

    def rec_prefill(*args):
        logits, cache = prefill(*args)
        recs.append({"logits": logits.clone()})
        return logits, cache

    def rec_admit(params):
        n = len(recs)
        admit(params)
        if len(recs) > n:
            recs[-1]["cache"] = [x.clone() for x in leaves(srv.cache)]

    srv._prefill, srv._admit = rec_prefill, rec_admit
    rng = np.random.default_rng(seed)
    vocab = srv.model.cfg.vocab_size
    before = launch_counts()
    rids = []
    for wave in waves:
        n = len(recs)
        rids += [srv.submit(rng.integers(0, vocab, size=k),
                            max_new_tokens=max_new) for k in wave]
        srv.run(params)
        assert len(recs) == n + 1, wave
    torch.cuda.synchronize()
    after = launch_counts()
    return (recs, [srv.completed[r].tokens for r in rids],
            {w.__name__: after[w] - before[w] for w in after})


def _admit_modes(tracer):
    """The ``(rows, rung)`` and ``mode`` of each ``engine.admit`` span."""
    return [((s.attrs["rows"], s.attrs["rung"]), s.attrs["mode"])
            for s in tracer.spans() if s.name == "engine.admit"]


@pytest.mark.parametrize("kind,profiled", [("dense", False),
                                           ("hymba", False),
                                           ("hymba", True)])
def test_prefill_graph_replays_equal_eager_prefill(dev, kind, profiled):
    """Two length rungs at two batch rungs, interleaved, through a server
    whose ladder prefills run from CUDA graphs and through one that runs
    them eagerly (both decode from their graph): each shape's first
    dispatch runs eagerly, its second captures, the later ones replay; the
    logits of every dispatch and every slot-cache leaf after its placement
    are the eager server's bit for bit, and so are the streams and each
    kernel's launch count (the capture's taken back, each replay's
    credited). ``profiled``: with ``torch.profiler`` recording throughout,
    as the benchmark's traced runs do."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.tracer import Tracer

    model = _small_model(kind, dev)
    params = _params(model, 0)
    waves = _prefill_waves(kind)
    runs = []
    for graphed in (True, False):
        tr = Tracer()
        srv = _server(model, graph=True, tracer=tr)
        if not graphed:
            _eager_prefill(srv)
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else contextlib.nullcontext())
        with ctx:
            runs.append(_serve_waves(srv, params, waves) + (srv, tr))
    (g_recs, g_toks, g_launch, g_srv, g_tr), (e_recs, e_toks, e_launch,
                                              e_srv, e_tr) = runs
    modes = _admit_modes(g_tr)
    assert len(modes) == len(waves) == 16
    for shape in {sh for sh, _ in modes}:
        assert [m for sh, m in modes if sh == shape] == [
            "eager", "capture", "replay", "replay"], shape
    assert len({sh for sh, _ in modes}) == 4
    assert {m for _, m in _admit_modes(e_tr)} == {"eager"}
    assert g_srv.stats["prefill_graph_captures"] == 4
    assert g_srv.stats["prefill_graph_replays"] == 8
    assert g_srv.engine_report()["prefill"]["graph"] is True
    assert e_srv.stats["prefill_graph_captures"] == 0
    assert e_srv.engine_report()["prefill"]["graph"] is False
    for i, (g, e) in enumerate(zip(g_recs, e_recs, strict=True)):
        assert torch.equal(g["logits"], e["logits"]), i
        for j, (a, b) in enumerate(zip(g["cache"], e["cache"], strict=True)):
            assert torch.equal(a, b), (i, j)
    assert g_toks == e_toks
    assert g_launch == e_launch
    assert g_launch["flash_attention_op"] == (
        model.cfg.num_layers * len(waves))


@pytest.mark.parametrize("kind", ["hymba", "moe"])
def test_exact_prefill_stays_eager(dev, kind):
    """Dispatches off the ladder run eagerly however often their shape
    comes: hymba's prompts past its window (the ladder's cap) and every
    prompt of a model that pads none (dbrx's experts)."""
    from repro_torch.obs.tracer import Tracer

    model = _small_model(kind, dev)
    assert bool(model.extras.get("prompt_pad")) is (kind == "hymba")
    params = _params(model, 0)
    tr = Tracer()
    srv = _server(model, graph=True, tracer=tr)
    waves = [[20], [20], [20], [20, 20], [20, 20], [20, 20]]
    _serve_waves(srv, params, waves)
    modes = _admit_modes(tr)
    assert [m for _, m in modes] == ["eager"] * len(waves)
    assert {sh for sh, _ in modes} == {(1, 20), (2, 20)}
    assert srv.stats["prefill_graph_captures"] == 0
    assert srv.stats["prefill_graph_replays"] == 0
    assert srv.engine_report()["prefill"]["graph"] is False


def test_new_params_tree_recaptures_the_prefill(dev):
    """Another params tree starts every prefill shape over: eager, then a
    new capture; the streams equal an eager server's on the same
    sequence."""
    from repro_torch.obs.tracer import Tracer

    model = _small_model("dense", dev)
    p0, p1 = _params(model, 0), _params(model, 1)
    waves = [[5], [6], [7]]
    streams = []
    for graphed in (True, False):
        tr = Tracer()
        srv = _server(model, graph=graphed, tracer=tr)
        first = _serve_waves(srv, p0, waves)[1]
        graphs = dict(srv._prefill_graphs)
        second = _serve_waves(srv, p1, waves, seed=1)[1]
        if graphed:
            assert [m for _, m in _admit_modes(tr)] == [
                "eager", "capture", "replay"] * 2
            assert srv._prefill_graph_params is p1
            assert srv._prefill_graphs[(1, 8)] is not graphs[(1, 8)]
        streams.append((first, second))
    assert streams[0] == streams[1]


def test_prefill_capture_error_raises_without_eager_fallback(dev):
    """An error while a prefill is captured propagates, the launch counts
    as they were; the shape's next dispatch tries the capture again and
    raises again: none runs eagerly in its place."""
    import dataclasses

    import numpy as np

    from repro_torch.kernels import launch_counts

    model = _small_model("dense", dev)
    params = _params(model, 0)
    srv = _server(model, graph=True)
    prefill = model.prefill

    def refuse_capture(*args, **kw):
        out = prefill(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused during capture")
        return out

    srv.model = dataclasses.replace(model, prefill=refuse_capture)
    rng = np.random.default_rng(0)
    srv.submit(rng.integers(0, model.cfg.vocab_size, size=5),
               max_new_tokens=2)
    srv.run(params)                          # the shape's eager dispatch
    assert srv.prefill_dispatches == 1
    for _ in range(2):
        srv.submit(rng.integers(0, model.cfg.vocab_size, size=6),
                   max_new_tokens=2)
        before = launch_counts()
        with pytest.raises(RuntimeError, match="refused during capture"):
            srv.step(params)
        assert launch_counts() == before
        assert srv.prefill_graph_captures == 0
        assert srv._prefill_graphs[(1, 8)] is None


def test_contextual_store_on_card_matches_cpu(dev):
    """Batched Exp3 and Exp4 feedback on the card against the same batches
    on the CPU: batches of 64 users out of 50, so users repeat, and each
    user's last occurrence lands on both devices. Within 1e-6 plus two fp32
    ulps of the largest log-weight (the card's exp and log against the
    CPU's)."""
    import numpy as np

    from repro_torch.core.context import ContextualStore

    for kind in ("exp3", "exp4"):
        stores = [ContextualStore(50, 4, kind=kind, eta=0.5, device=d)
                  for d in ("cpu", dev)]
        rng = np.random.default_rng(0)
        for _ in range(20):
            users = rng.integers(0, 120, size=64)
            assert len(np.unique(users % 50)) < len(users)
            stores[1].load_state_dict(stores[0].state_dict())
            if kind == "exp3":
                chosen = rng.integers(0, 4, size=64)
                losses = rng.random(64).astype(np.float32)
                for st in stores:
                    st.observe_exp3(users, chosen, losses)
            else:
                losses = rng.random((64, 4)).astype(np.float32)
                avail = rng.random((64, 4)) < 0.8
                for st in stores:
                    st.observe_exp4(users, losses, avail)
            want = stores[0].states
            tol = 1e-6 + 2 * float(torch.finfo(torch.float32).eps
                                   * want.abs().max())
            torch.testing.assert_close(stores[1].states.cpu(), want,
                                       rtol=0, atol=tol)
        assert stores[1].states.device.type == "cuda"


def test_frontend_scenario_on_card_matches_cpu(dev):
    """The stragglers scenario's frontend stack with its selection state on
    the card: the report is the CPU run's, byte for byte, and every query
    rendered from more than one model read the state once."""
    from repro_torch.workloads.scenario import ScenarioRunner, SCENARIOS

    sc = SCENARIOS["stragglers"]
    reports = [ScenarioRunner(sc, device=d).run_json("frontend")
               for d in ("cpu", dev)]
    assert reports[1] == reports[0]


def test_lmserver_scenario_on_card_matches_cpu(dev):
    """The poisson scenario's lmserver stack on the card (its decode step
    and its ladder prefills replayed from CUDA graphs) and on the CPU: the
    reports agree but for ``engine.attention_backend``,
    ``engine.decode.graph`` and ``engine.prefill.graph``; the kernels
    ran."""
    import json

    from repro_torch.workloads.scenario import ScenarioRunner, SCENARIOS

    ops = (rmsnorm_op, decode_attention_op, flash_attention_op)
    before = [op.launches for op in ops]
    card = ScenarioRunner(SCENARIOS["poisson"], device=dev).run("lmserver")
    assert all(op.launches > b for op, b in zip(ops, before))
    cpu = ScenarioRunner(SCENARIOS["poisson"], device="cpu").run("lmserver")
    assert card["engine"]["attention_backend"] == "kernels"
    assert card["engine"]["decode"].pop("graph") is True
    assert cpu["engine"]["decode"].pop("graph") is False
    assert card["engine"]["prefill"].pop("graph") is True
    assert cpu["engine"]["prefill"].pop("graph") is False
    cpu["engine"]["attention_backend"] = "kernels"
    assert json.dumps(card, sort_keys=True) == json.dumps(cpu, sort_keys=True)


def _engine_free(rep, sections):
    """A report with each named section's two engine fields taken out,
    after checking what they say, and its ``engine.prefill.graph`` (the
    card replays a ladder prefill from a graph where a tier dispatched its
    shape more than twice; the CPU never)."""
    import json

    rep = json.loads(json.dumps(rep))
    seen = []
    for path in sections:
        sec = rep
        for key in path:
            sec = sec[key]
        seen.append((sec["engine"].pop("attention_backend"),
                     sec["engine"]["decode"].pop("graph")))
        graphed = sec["engine"]["prefill"].pop("graph")
        assert graphed in (False, seen[-1][0] == "kernels"), graphed
    return rep, seen


def test_lmcascade_on_card_matches_cpu(dev):
    """The pipeline scenario's reduced lmcascade: two ``LMServer`` tiers on
    one card, both given the one params tree, each capturing and replaying
    its own decode graph (the verify tier captures while the draft's graph
    exists). The report equals the CPU run's but each tier's engine fields,
    so do each request's tier and the span log; the launches credited per
    replay add up across the tiers. A third run on the card with both
    tiers' steps eager, whose logits can be read (a graph's cannot), gives
    the graphed run's streams; each stream equals the CPU's up to the
    first step where they part, and up to there the two devices' logits
    agree within ``CASCADE_LOGIT_TOL``."""
    from repro_torch.obs import Tracer
    from repro_torch.pipeline.scenario import (build_lmcascade,
                                               drive_lmcascade,
                                               pipeline_scenario)
    from repro_torch.serving import engine as torch_engine

    sc = pipeline_scenario()
    ops = {"rmsnorm": rmsnorm_op, "decode_attention": decode_attention_op,
           "flash_attention": flash_attention_op}
    runs, logits = {}, {}
    for tag, d in (("cpu", "cpu"), ("cuda", dev), ("eager", dev)):
        # no step spans: their decode modes differ between the devices
        tr = Tracer(sample_rate=1.0, seed=sc.seed, engine=False)
        casc, clock, params, pending = build_lmcascade(sc, tracer=tr,
                                                       device=d)
        with pytest.MonkeyPatch.context() as mp:
            if tag != "cuda":
                logits[tag] = [record_logits(
                    mp, srv, torch_engine,
                    lambda x, out: out.append(x.float().cpu().numpy()),
                    lambda: None) for srv in (casc.draft, casc.verify)]
            if tag == "eager":
                for srv in (casc.draft, casc.verify):
                    mp.setattr(srv, "_decode_device",
                               lambda p, srv=srv: srv._decode_fused(
                                   p, *srv._slot_state()))
            before = {k: op.launches for k, op in ops.items()}
            rep = drive_lmcascade(sc, casc, clock, params, pending)
        runs[tag] = (rep, tr.to_json(), casc,
                     {k: op.launches - before[k] for k, op in ops.items()})
    tiers = (("cascade", "draft"), ("cascade", "verify"))
    cpu, seen_cpu = _engine_free(runs["cpu"][0], tiers)
    card, seen_card = _engine_free(runs["cuda"][0], tiers)
    assert seen_cpu == [("plain", False)] * 2
    assert seen_card == [("kernels", True)] * 2
    assert card == cpu
    assert runs["cuda"][1] == runs["cpu"][1]
    casc, launches = runs["cuda"][2], runs["cuda"][3]
    assert ({c: r["tier"] for c, r in casc.results.items()}
            == {c: r["tier"] for c, r in runs["cpu"][2].results.items()})
    for i, tier in enumerate(("draft", "verify")):
        cpu_s, card_s, eager_s = (
            {rid: r.tokens for rid, r in
             getattr(runs[t][2], tier).completed.items()}
            for t in ("cpu", "cuda", "eager"))
        assert eager_s == card_s, tier
        worst, _ = stream_divergence(cpu_s, eager_s, logits["cpu"][i],
                                     logits["eager"][i])
        assert worst <= CASCADE_LOGIT_TOL, (tier, worst)
    assert 0 < casc.escalated < sc.lm_requests
    srvs = (casc.draft, casc.verify)
    assert srvs[0]._graph is not None and srvs[1]._graph is not None
    assert srvs[0]._graph is not srvs[1]._graph
    for srv in srvs:
        assert srv.graph_replays == srv.decode_steps - 1 > 0
    L = casc.draft.model.cfg.num_layers
    steps = sum(s.decode_steps for s in srvs)
    prefills = sum(s.prefill_dispatches for s in srvs)
    assert launches == {"decode_attention": L * steps,
                        "flash_attention": L * prefills,
                        "rmsnorm": (2 * L + 1) * (steps + prefills)}


def test_cluster_lmserver_stack_on_card_matches_cpu(dev):
    """The control plane's lmserver stack with shedding admission on the
    card: the decode step replays from its graph, and the report is the
    CPU run's but the engine fields."""
    from repro_torch.cluster.plan import (ClusterPlan, cluster_scenario,
                                          run_plan)

    sc = cluster_scenario("flash_crowd", seed=0)
    reps = [run_plan(ClusterPlan(scenario=sc, stack="lmserver",
                                 admission="shed", device=d))
            for d in ("cpu", dev)]
    cpu, seen_cpu = _engine_free(reps[0], ((),))
    card, seen_card = _engine_free(reps[1], ((),))
    assert seen_cpu == [("plain", False)]
    assert seen_card == [("kernels", True)]
    assert card == cpu
    assert card["admission"]["shed"] > 0


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

def test_kernel_wrappers_refuse_autograd_on_the_card(dev):
    """No kernel may cut the autograd graph: each wrapper, given a CUDA
    input that requires a gradient with autograd on, raises naming itself;
    under ``torch.no_grad()`` the same call launches its kernel."""
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn((8, 64), gen, dev)
    w = torch.ones(64, dtype=torch.bfloat16, device=dev)
    q = _randn((2, 1, 4, 64), gen, dev)
    kv = _randn((2, 16, 2, 64), gen, dev)
    ln = torch.tensor([5, 16], dtype=torch.int32, device=dev)
    qf, kf = _randn((2, 16, 4, 64), gen, dev), _randn((2, 16, 2, 64), gen, dev)
    z = _randn((1, 8, 2, 16), gen, dev)
    g = -torch.rand((1, 8, 2), generator=gen, device=dev)
    calls = {
        "rmsnorm_op": (rmsnorm_op, lambda r: (x.requires_grad_(r), w)),
        "decode_attention_op": (decode_attention_op,
                                lambda r: (q.requires_grad_(r), kv, kv, ln)),
        "flash_attention_op": (flash_attention_op,
                               lambda r: (qf.requires_grad_(r), kf, kf)),
        "ssd_scan_op": (ssd_scan_op,
                        lambda r: (z.requires_grad_(r), z, z, g, g)),
    }
    for name, (op, args) in calls.items():
        with pytest.raises(RuntimeError, match=name):
            op(*args(True))
        before = op.launches
        with torch.no_grad():
            op(*args(True))
        assert op.launches == before + 1, name
        args(False)


@pytest.mark.parametrize("kind", ["dense", "xlstm", "hymba", "encdec", "vlm",
                                  "moe"])
def test_training_step_on_card_matches_cpu(dev, kind):
    """One ``loss_fn`` + backward of each reduced family on the card
    against the CPU's plain path, the same weights and batch: the card
    launches no kernel; the loss within 1 %, each gradient leaf within 8
    bf16 roundings of the CPU leaf's largest |g| (40 for hymba's fp32 SSD
    leaves ``d_skip`` and ``b_dt``: chip_smoke.py's ``GRAD_ROUNDINGS``)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import launch_counts
    from repro_torch.models.api import build_model
    from repro_torch.training.grad_compress import _accumulate
    from repro_torch.tree import flatten_with_paths

    card = _small_model(kind, dev)
    cpu = build_model(card.cfg, device="cpu",
                      **({"chunk": 8} if kind == "xlstm" else {}))
    params = cpu.init(torch.Generator().manual_seed(0))
    seq = 16 + card.cfg.num_prefix_embeddings if kind == "vlm" else 32
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLMData(
        card.cfg, ShapeSpec("t", seq, 4, "train"), seed=2).batch_at(0).items()}
    before = launch_counts()
    loss, grads = _accumulate(card.loss_fn, _tree_to(params, dev),
                              _tree_to(batch, dev), 1)
    assert launch_counts() == before
    cpu_loss, cpu_grads = _accumulate(cpu.loss_fn, params, batch, 1)
    assert abs(float(loss) - float(cpu_loss)) <= 0.01 * abs(float(cpu_loss))
    want = dict(flatten_with_paths(cpu_grads))
    for path, g in flatten_with_paths(grads):
        w = want[path]
        limit = 40 if path.endswith(("ssd/d_skip", "ssd/b_dt")) else 8
        err = float((g.cpu() - w).abs().max() / (w.abs().max() * 2.0 ** -8))
        assert err <= limit, (path, err)


# ---------------------------------------------------------------------------
# the examples' predictors (examples/common_torch.py) on the card
# ---------------------------------------------------------------------------

def _examples_common():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "common_torch.py"
    spec = importlib.util.spec_from_file_location("common_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fig3_predictors_on_card_match_cpu(dev):
    """The five predictors of the Fig 3 spectrum, the same weights on the
    card and on the CPU (bit-equal), at the demo's batch sizes: outputs on
    the card within 1e-5 of the largest |output| (fp32 products summed in
    other orders; TF32 would miss it by far: tests/test_torch_examples.py's
    ``PRED_RTOL``)."""
    import numpy as np

    T = _examples_common()
    card = T.make_containers(np.random.default_rng(0), dev)
    cpu = T.make_containers(np.random.default_rng(0), "cpu")
    for b in (1, 7, 64, 241):
        x = np.random.default_rng(b).normal(size=(b, T.D_FEAT)).astype(
            np.float32)
        for name in cpu:
            got = card[name](torch.from_numpy(x).to(dev))
            assert got.device.type == "cuda", name
            want = cpu[name](torch.from_numpy(x))
            gap = float((got.cpu() - want).abs().max() / want.abs().max())
            assert gap <= 1e-5, (name, b, gap)


def test_train_linear_model_on_card_matches_cpu(dev):
    """The ensemble's linear model trained on the card against the CPU:
    the same draws from the numpy generator, class probabilities within
    1e-5 and the same class on 1,000 seeded points
    (tests/test_torch_examples.py's ``TRAIN_ATOL``)."""
    import numpy as np

    T = _examples_common()
    rc, rg = np.random.default_rng(3), np.random.default_rng(3)
    W, _ = T.make_task(rc)
    T.make_task(rg)
    card = T.train_linear_model(rc, W, noise=0.3, device=dev)
    cpu = T.train_linear_model(rg, W, noise=0.3, device="cpu")
    assert rc.bit_generator.state == rg.bit_generator.state
    x = np.random.default_rng(9).normal(size=(1000, T.D_FEAT)).astype(
        np.float32)
    got = card(torch.from_numpy(x).to(dev))
    assert got.device.type == "cuda"
    want = cpu(torch.from_numpy(x))
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    assert torch.equal(got.cpu().argmax(-1), want.argmax(-1))


def test_expert_parallel_moe_on_ranks_sharing_the_card(dev, tmp_path):
    """dbrx reduced (2 layers, d_model 64, 4 experts top-2) on four gloo
    ranks sharing the card, one expert a rank (``ep`` over (1, 4)): the
    prefill logits and 4 greedy decode steps of every rank equal the
    one-device port's within 2 bf16 roundings of each row's largest
    logit (the ranks' partial sums meet in another order), the same on
    every rank, and the decode kernel runs on each."""
    import _torch_dist_ranks as R
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.api import build_model
    from repro_torch.serving.sampler import sample

    cfg = R.config(R.SERVE_CASE["arch"], R.SERVE_CASE["capacity"])
    one = build_model(cfg.padded_config(4), device=dev)
    params = one.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1)).to(
        device=dev, dtype=torch.int32)
    want, _ = R._prefill_and_decode(one, params, tokens, decode_attention_op,
                                    sample)
    ranks = run_ranks(R.card_ep_rank, 4, params, tokens, device="cuda",
                      share=True, timeout=300, tmpdir=str(tmp_path))
    for got, launches in ranks:
        assert launches == 4 * cfg.num_layers
        for g, w in zip(got, want):
            assert abs(g - w).max() <= 2 * BF16_ULP * abs(w).max()
        for g, r0 in zip(got, ranks[0][0]):
            assert (g == r0).all()
