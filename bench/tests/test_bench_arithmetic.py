"""The end-to-end metrics' arithmetic over requests censored at the
window's end, and the model and kernel counts against hand counts at a
tiny configuration."""

import math

import pytest

import _tiny
from bench import calls, harness, model_count as MC, stats
from bench.frozen import work as W


def _run(reqs, ws=10.0, end=20.0):
    """A run whose requests are ``(due, token times)``."""
    tracked = []
    for due, times in reqs:
        tr = harness.Tracked(due, None)
        tr.times = list(times)
        tr.first_t = times[0] if times else None
        tracked.append(tr)
    return harness.Run(ws=ws, end=end, requests=tracked, setup_s=3.5)


def read(kind, name, run):
    return harness.reader(kind, name)(run)


def test_tokens_per_s_counts_only_the_window():
    run = _run([(9.0, [9.5, 10.5, 11.0]), (12.0, [13.0, 19.0, 21.0]),
                (19.5, [])])
    assert read("e2e", "tokens_per_s", run) == pytest.approx(4 / 10.0)


def test_ttft_censors_at_the_window_end():
    # due 12 -> 1 s; due 19 first token after the end -> 20 - 19; due 19.5
    # none -> 0.5; due 9 is before the window and does not count
    run = _run([(9.0, [9.2]), (12.0, [13.0]), (19.0, [25.0]),
                (19.5, [])])
    vals = [1.0, 1.0, 0.5]
    assert read("e2e", "ttft_p95_ms", run) == pytest.approx(
        1e3 * stats.percentile(vals, 95))


def test_tpot_counts_from_the_first_token_to_the_window_end():
    run = _run([(9.0, [9.5, 10.0, 10.5, 11.0]),   # 3 in: (11 - 9.5) / 3
                (12.0, [13.0, 13.2, 21.0]),        # 2 in, cut at 20: 0.2
                (8.0, [8.5, 9.0, 10.2]),           # 1 in: none
                (15.0, [16.0])])                    # one token: none
    assert read("e2e", "tpot_p95_ms", run) == pytest.approx(
        1e3 * stats.percentile([0.5, 0.2], 95))


def test_setup_and_spread():
    assert read("e2e", "setup_s", _run([])) == 3.5
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    q = __import__("statistics").quantiles([1, 2, 3, 4, 5, 6], n=4)
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (q[2] - q[0]) / 3.5)


def test_hymba_counts_by_hand():
    c = _tiny.HYMBA
    d, nq, nkv, hd, ds, dff, V = 64, 4, 2, 16, 4, 128, 300
    attn = d * nq * hd * 2 + d * nkv * hd * 2
    ssd = d * 2 * d + d * 2 * nq * ds + d * nq + d * d
    per_tok = 4 * (attn + ssd + 3 * d * dff) + d * V
    assert MC.matmul_params_per_token("hybrid", c) == per_tok
    # position 40: global layers see 41 positions, windowed ones 32
    f = 2 * per_tok + 2 * 4 * nq * hd * 41 + 2 * 4 * nq * hd * 32 \
        + 4 * 4 * nq * ds * hd
    assert MC.token_flops("hybrid", c, 40) == f
    # a prompt of 40: global pairs 40*41/2, windowed 32*33/2 + 8*32
    pf = 2 * per_tok * 40 + 2 * 4 * nq * hd * (820 + 528 + 256) \
        + 4 * 4 * nq * ds * hd * 40
    assert MC.prompt_flops("hybrid", c, 40) == pf
    wb = MC.weight_bytes("hybrid", c)
    kv = 2 * (2 * 41 + 2 * 32) * nkv * hd * 2
    st = 4 * 2 * (nq * ds * hd * 4 + 3 * nq * hd * 2)
    assert MC.decode_step_bytes("hybrid", c, [40]) == wb + kv + st


def test_moe_counts_by_hand():
    c = _tiny.MOE
    d, nq, nkv, hd, dff, E, k, V = 64, 4, 2, 16, 96, 4, 2, 300
    L = c["num_layers"]
    attn = d * nq * hd * 2 + d * nkv * hd * 2
    assert MC.matmul_params_per_token("moe", c) == \
        L * (attn + k * 3 * d * dff + d * E) + d * V
    wb = L * ((attn + E * 3 * d * dff + 2 * d) * 2 + d * E * 4) \
        + d * V * 2 + d * 2
    assert MC.weight_bytes("moe", c) == wb


def test_bounds_by_hand():
    c = _tiny.HYMBA
    # one slot at position 40: global layers read 41 rows, windowed 32
    b = calls.decode_attention_bound("hybrid", c, 96, [40])
    by = 2 * (2 * 4 * 16 * 2 + 4 + 2 * 41 * 2 * 16 * 2) \
        + 2 * (2 * 4 * 16 * 2 + 4 + 2 * 32 * 2 * 16 * 2)
    assert b == pytest.approx(by / MC.PEAK_BYTES)
    n = calls.rmsnorm_bound("hybrid", c, 3)
    assert n == pytest.approx(17 * max((2 * 3 * 64 + 64) * 2 / MC.PEAK_BYTES,
                                       4 * 3 * 64 / MC.PEAK_F32))


def test_scan_valid_work_matches_whole_chunks():
    a = W.ssd_scan_work(1, 512, 25, 16, 64, chunk=256, state_in=False)
    b = W.ssd_scan_valid_work([512], 25, 16, 64, chunk=256, state_in=False)
    assert a.bytes == b.bytes and a.flops == b.flops
    two = W.ssd_scan_valid_work([512, 512], 25, 16, 64, chunk=256,
                                state_in=False)
    assert two.flops["bf16"] == 2 * a.flops["bf16"]
    # a partial chunk of 100: its own causal half
    p = W.ssd_scan_valid_work([100], 1, 16, 64, chunk=256, state_in=False)
    assert p.flops["bf16"] == 2 * 1 * (100 * 101 // 2) * 16


def test_flash_bound_each_prompt_alone():
    c = _tiny.HYMBA
    b = calls.flash_bound("hybrid", c, [40, 10])
    one = sum(n * calls.bound_s(W.flash_attention_work(
        1, L, 4, 2, 16, window=w)) for L in (40, 10)
        for n, w in ((2, 0), (2, 32)))
    assert b == pytest.approx(one)
    assert math.isfinite(b) and b > 0


def test_trace_arithmetic():
    from bench import layers
    from bench import trace as TR
    dev = [("void decode_attention_kernel<64, 8>(...)", 10.0, 14.0),
           ("nvjet_gemm", 12.0, 20.0),
           ("rmsnorm_kernel", 30.0, 31.0),
           ("void flash_attention_kernel<...>", 50.0, 60.0)]
    tr = {"device": dev, "decodes": [(9.0, 25.0)], "admits": [(45.0, 70.0),
                                                              (80.0, 81.0)]}
    # union inside the decode call: 10..20 -> 10 us of 16
    assert TR.clip_union(dev, [(9.0, 25.0)]) == 10.0
    assert TR.kernel_us(tr, ("decode_attention_kernel",)) == 4.0
    assert TR.kernel_us(tr, ("rmsnorm_kernel",), [(9.0, 25.0)]) == 0.0
    run = harness.Run(trace=tr)
    assert layers.idle_share(run, "decode") == pytest.approx(
        100 * (1 - 10 / 16))
    # the admission without device work is no prefill
    assert layers.trace_spans(run, "admit") == [(45.0, 70.0)]
    assert layers.idle_share(run, "admit") == pytest.approx(
        100 * (1 - 10 / 25))
    assert layers.kernel_share(run, "admit", ("flash_attention_kernel",),
                               5e-6) == pytest.approx(50.0)
    assert layers.kernel_share(run, "decode", ("absent",), 1.0) is None


class _Span:
    def __init__(self, start, end, attrs):
        self.component, self.start, self.end = "lm.prefill", start, end
        self.attrs = attrs


@pytest.mark.parametrize("name,untraced,traced", [
    ("decode_step_ms", 2.0, 30.0), ("mfu.decode", 2.0, 30.0),
    ("membw.decode", 2.0, 30.0), ("prefill_ms_per_ktok", 4.0, 60.0),
    ("mfu.prefill", 4.0, 60.0)])
def test_host_clock_readers_leave_out_the_profiled_span(name, untraced,
                                                        traced):
    """A call inside the profiled span, which the profiler slows, changes
    none of the readings taken on the host clock."""
    def run_with(slow):
        decodes = [dict(t0=11.0 + k, t1=11.0 + k + untraced / 1e3,
                        positions=[40, 41], traced=False) for k in range(3)]
        admits = [dict(t0=12.5, t1=12.6, lengths=[30], rung=32,
                       padded=True, traced=False)]
        spans = [_Span(12.5, 12.5 + untraced / 1e3,
                       {"batch": 1, "padded_len": 32})]
        if slow:
            decodes.append(dict(t0=18.0, t1=18.0 + traced / 1e3,
                                positions=[40, 41], traced=True))
            admits.append(dict(t0=18.5, t1=18.6, lengths=[30], rung=32,
                               padded=True, traced=True))
            spans.append(_Span(18.5, 18.5 + traced / 1e3,
                               {"batch": 1, "padded_len": 32}))
        return harness.Run(ws=10.0, end=20.0, cfg=_tiny.HYMBA,
                           family="hybrid", decodes=decodes, admits=admits,
                           spans=spans,
                           profiled=(17.0, 20.0) if slow else None)
    base = read("metrics", name, run_with(False))
    assert base is not None and base > 0
    assert read("metrics", name, run_with(True)) == pytest.approx(base)
