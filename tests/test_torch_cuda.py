"""The port's kernels on the card, each against its plain PyTorch version,
and ``LMServer`` on the card: its fused decode step replayed from a CUDA
graph against the same step run eagerly.

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

from repro_torch.kernels.decode_attention.ops import decode_attention_op
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm_op
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

BF16_ULP = 2.0 ** -7

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _randn(shape, gen, dev, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(
        torch.bfloat16)


def _close(got, want, rtol, atol):
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n,d", [(1, 960), (37, 960), (8, 64), (5, 3000)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_kernel(dev, n, d, residual):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn((n, d), gen, dev)
    w = _randn((d,), gen, dev, 0.25) + 1
    r = _randn((n, d), gen, dev) if residual else None
    before = rmsnorm_op.launches
    got = rmsnorm_op(x, w, residual=r)
    torch.cuda.synchronize()
    assert rmsnorm_op.launches == before + 1
    want = rmsnorm_ref(x, w, residual=r)
    if residual:
        _close(got[0], want[0], 0, 0)         # one bf16 add: exact
        got, want = got[1], want[1]
    _close(got, want, BF16_ULP, 1e-5)


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
    (3, 6, 2, 20, 50, [50, 7, 33], 0),             # D % 8: 4-byte loads
    (2, 8, 1, 100, 40, [40, 3], 0),                # G = 8, D = 100: 2 a lane
    (2, 16, 2, 128, 1000, [1000, 517], 0),         # G = 8, four warps
    (2, 6, 2, 20, 700, [700, 300], 0),             # 4-byte loads, four warps
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


def test_decode_attention_replays_in_a_cuda_graph(dev):
    """The cluster launch captured in a CUDA graph replays to the eager
    output, also after the inputs change in place. Same kernel, same inputs,
    a fixed merge order and no atomics: equal bit for bit."""
    B, Hq, Hkv, D, Smax = 8, 15, 5, 64, 256
    gen = torch.Generator(device=dev).manual_seed(5)
    q = _randn((B, 1, Hq, D), gen, dev)
    k = _randn((B, Smax, Hkv, D), gen, dev)
    v = _randn((B, Smax, Hkv, D), gen, dev)
    ln = torch.tensor([0, 1, 37, 128, 200, 255, 256, 64], dtype=torch.int32,
                      device=dev)
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
                                  dtype=torch.int32, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        eager = decode_attention_op(q, k, v, ln)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        _close(captured, decode_attention_ref(q, k, v, ln), BF16_ULP,
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


def test_wrappers_raise_on_unsupported_card_inputs(dev):
    q = torch.zeros((1, 1, 4, 64), device=dev, dtype=torch.float32)
    kv = torch.zeros((1, 8, 2, 64), device=dev, dtype=torch.float32)
    ln = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):                   # fp32: no kernel, no fallback
        decode_attention_op(q, kv, kv, ln)
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

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(dev)

    card_params = to_card(cpu_params)
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

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(dev)

    card_params = to_card(cpu_params)
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


# ---------------------------------------------------------------------------
# the fused decode step as a CUDA graph
# ---------------------------------------------------------------------------

def _small_model(kind, dev):
    """A reduced dense model (G = 2, D = 32: shapes every kernel takes) or
    reduced xlstm (chunk 8), with seeded weights on the card."""
    import dataclasses

    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    from repro_torch.models.api import build_model

    if kind == "dense":
        cfg = dataclasses.replace(
            reduced_config(ARCHITECTURES["smollm-360m"]), num_heads=4,
            num_kv_heads=2, head_dim=32, d_model=128, d_ff=256)
        model = build_model(cfg, device=dev)
    else:
        model = build_model(reduced_config(ARCHITECTURES["xlstm-125m"]),
                            device=dev, chunk=8)
    return model


def _params(model, seed):
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def _server(model, *, graph, temperature=0.0, seed=0):
    """An LMServer in calibrated-simulation mode (admission decisions do
    not depend on wall time). ``graph=False`` runs every fused step
    eagerly, the step the graph captures."""
    from repro_torch.core.metrics import VirtualClock
    from repro_torch.serving.engine import LMServer

    srv = LMServer(model, device=model.device, slots=4, max_len=64,
                   temperature=temperature, seed=seed, clock=VirtualClock(),
                   service_model=lambda kind, b, t: 1e-3 * (1 + b * t))
    if not graph:
        srv._decode_device = lambda params: srv._decode_fused(
            params, *srv._slot_state())
    return srv


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
@pytest.mark.parametrize("kind", ["dense", "xlstm"])
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
