"""hymba (hybrid family) parity: the port against the JAX package on bridged
weights.

Reduced hymba-1.5b (d_model 64, 4 / 2 heads of 16, window 16, ssm_state 8,
conv width 4), bf16 with fp32 dt / decay / skip weights, on two configs of
``_torch_parity``: ``h2`` (2 layers, one global and one sliding-window,
chunk 256) and ``h5`` (5 layers, globals (0, 2, 4): the full model's
segment shape, chunk 8 so that prompts span several chunks).

The port rounds where the compiled reference rounds (ROADMAP.md §C), but
the two libraries' fp32 reductions (a GEMM's sum, RMSNorm's mean, the
scan's sums) and their exp and log differ in the last ulp, and now and then
that flips a bf16 rounding. One flipped element of an SSD input enters the
state scaled by the input gate (up to 8) and then every later layer, so a
flip shows up to ~1.4 bf16 roundings of the largest logit or leaf.

Tolerances: at ``h2`` the prefill logits equal the reference's bit for bit
(on these inputs no rounding flips) and the cache leaves are within one
bf16 rounding (rtol 2**-7; fp32 SSD states rtol 1e-5 plus 2e-6 of the
leaf's largest magnitude, ~16 fp32 ulps); at ``h5`` and after decode
steps, where flips occur, the logits and every leaf are within ``DRIFT``
bf16 roundings of their largest magnitude and the greedy choices are
equal. The port's padded and exact prefills are held to each other within
one rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import HYMBA_CONFIGS, build_pair, configs, f32
from test_torch_serving import assert_one_host_copy_per_step

from repro.models import common as JC
from repro.serving import engine as jax_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.models import common as TC
from repro_torch.serving.engine import _scatter_cache, batched_scatter

BF16_ULP = 2.0 ** -7
MAX_LEN = 48
# the cache's leaves, bf16 first, then the fp32 SSD states
BF16_LEAVES = ("kg", "vg", "kw", "vw", "conv_g", "conv_w")
STATE_LEAVES = ("ssd_g", "ssd_w")
# bf16 roundings of the largest magnitude by which a comparison that
# carries one-ulp flips may differ (module docstring): about twice the
# largest seen over these tests (1.35, h5's logits after a flip)
DRIFT = 3


@pytest.fixture(scope="module", params=HYMBA_CONFIGS)
def pair(request):
    return request.param, build_pair(request.param)


def _prompts(cfg, seed=0):
    """Three prompts right-padded to the window (16): one full, two
    shorter."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 11, 5], np.int32)
    return toks, lens


def _close_bf16(t, j):
    np.testing.assert_allclose(f32(t), f32(j), rtol=BF16_ULP, atol=1e-6)


def _close_state(t, j):
    j = f32(j)
    np.testing.assert_allclose(f32(t), j, rtol=1e-5,
                               atol=2e-6 * max(float(np.abs(j).max()), 1.0))


def _close_drift(t, j):
    j = f32(j)
    np.testing.assert_allclose(f32(t), j, rtol=0,
                               atol=DRIFT * BF16_ULP * np.abs(j).max())


def _close_cache(tc, jc, close_bf16=_close_bf16, close_state=_close_state):
    """Every leaf of the port's cache against the reference's: names,
    shapes, dtypes and values."""
    assert sorted(tc) == sorted(jc)
    for name in BF16_LEAVES + STATE_LEAVES:
        t, j = tc[name], jc[name]
        assert tuple(t.shape) == j.shape, name
        assert t.dtype == (torch.float32 if name in STATE_LEAVES
                           else torch.bfloat16), name
        (close_state if name in STATE_LEAVES else close_bf16)(t, j)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def _close_prefill(name, tl, jl, tc, jc):
    """h2: logits bit for bit, cache leaves within one rounding; h5: both
    within the drift bound."""
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    if name == "h2":
        np.testing.assert_array_equal(f32(tl), f32(jl))
        _close_cache(tc, jc)
    else:
        _close_drift(tl, jl)
        _close_cache(tc, jc, _close_drift, _close_drift)


def _jit_prefill(jm, jp, toks, lens=None):
    """The compiled reference's prefill (``lens`` None: exact prompts)."""
    def run(p, t, l):
        batch = {"tokens": t} if l is None else {"tokens": t, "lengths": l}
        return jm.prefill(p, batch, max_len=MAX_LEN)

    return jax.jit(run)(jp, toks, lens)


def _prefill_both(jm, jp, tm, tp, toks, lens=None):
    jl, jc = _jit_prefill(jm, jp, toks, lens)
    tb = {"tokens": torch.from_numpy(toks)}
    if lens is not None:
        tb["lengths"] = torch.from_numpy(lens)
    tl, tc = tm.prefill(tp, tb, max_len=MAX_LEN)
    return jl, jc, tl, tc


def _decode_both(jm, jp, tm, tp, jc, tc, lens, steps, seed=7):
    """``steps`` decode steps of both, free-running from their own caches
    and fed the same random tokens: the logits of each step within the
    drift bound, with the same greedy choice. Returns the two caches."""
    cfg = tm.cfg
    step = jax.jit(jm.decode_step)
    jlen, tlen = jnp.asarray(lens), torch.from_numpy(lens.copy())
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        nxt = rng.integers(0, cfg.vocab_size,
                           size=(len(lens), 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nxt), jlen)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tlen)
        _close_drift(tl, jl)
        np.testing.assert_array_equal(f32(tl).argmax(-1), f32(jl).argmax(-1))
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))
        jlen, tlen = jlen + 1, tlen + 1
    return jc, tc


def _bridged(tree):
    """The reference's cache (or any tree of arrays) as torch tensors on
    the CPU, bit for bit."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def test_seeded_init_matches_reference_tree(pair):
    """Same tree, shapes and dtypes as the reference (fp32 dt, decay and
    skip weights), the same values for the same seed, and the reference's
    weights bridged bit for bit."""
    _, (jm, jp, tm, tp) = pair
    p0 = tm.init(torch.Generator().manual_seed(0))
    p1 = tm.init(torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    ours = jax.tree_util.tree_flatten_with_path(p0)[0]
    assert [k for k, _ in ours] == [k for k, _ in flat]
    assert len(flat) == 3 + 2 * 19          # embed, then per stack 19 leaves
    for (_, a), b, (_, r) in zip(ours, jax.tree.leaves(p1), flat):
        assert tuple(a.shape) == r.shape
        assert a.dtype == (torch.float32 if r.dtype == np.float32
                           else torch.bfloat16)
        assert torch.equal(a, b)
    for stack in ("g", "swa"):
        for name in ("w_dt", "b_dt", "a_log", "d_skip"):
            assert p0[stack]["ssd"][name].dtype == torch.float32
    # the bridge carries the reference's tree (embed, g, swa with nested
    # attn, ssd and ffn) across bit for bit, fp32 leaves included
    bridged = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [k for k, _ in bridged] == [k for k, _ in flat]
    for (_, t), (_, r) in zip(bridged, flat):
        assert t.dtype == (torch.float32 if r.dtype == np.float32
                           else torch.bfloat16)
        np.testing.assert_array_equal(f32(t), f32(r))


def test_prefill_logits_and_cache(pair):
    """Padded prompts of 16, 11 and 5 tokens (the ring's no-wrap layout,
    junk rows past each prompt)."""
    name, (jm, jp, tm, tp) = pair
    toks, lens = _prompts(configs(name)[1])
    jl, jc, tl, tc = _prefill_both(jm, jp, tm, tp, toks, lens)
    _close_prefill(name, tl, jl, tc, jc)


def test_decode_16_steps_wraps_the_ring(pair):
    """Prompts of 16, 11 and 5 tokens and 16 decode steps: every ring of
    16 slots wraps (lengths reach 32, 27 and 21). Free-running, both
    sides carry their own one-ulp flips, so the cache after the steps is
    held to the drift bound."""
    name, (jm, jp, tm, tp) = pair
    toks, lens = _prompts(configs(name)[1])
    _, jc, _, tc = _prefill_both(jm, jp, tm, tp, toks, lens)
    jc, tc = _decode_both(jm, jp, tm, tp, jc, tc, lens, 16)
    assert (tc["lengths"] > tm.cfg.window).all()
    _close_cache(tc, jc, _close_drift, _close_drift)


def test_exact_prompt_past_the_window(pair):
    """An exact prompt of 24 tokens (> window 16): the window binds in the
    prefill's attention and each ring holds the last 16 K/V rows rolled by
    24 % 16 = 8, position p at slot p % 16; then 8 decode steps."""
    name, (jm, jp, tm, tp) = pair
    cfg = configs(name)[1]
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    jl, jc, tl, tc = _prefill_both(jm, jp, tm, tp, toks)
    _close_prefill(name, tl, jl, tc, jc)
    # the model is causal, so positions 8..15 have the K/V rows of the
    # 16-token prefix, whose ring does not wrap (position p at slot p):
    # slots 8..15 agree, slots 0..7 hold positions 16..23 instead of 0..7
    _, short = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])})
    for leaf in ("kw", "vw"):
        _close_bf16(tc[leaf][:, :, 8:], short[leaf][:, :, 8:])
        assert not torch.equal(tc[leaf][:, :, :8], short[leaf][:, :, :8])
    lens = np.full((2,), 24, np.int32)
    jc, tc = _decode_both(jm, jp, tm, tp, jc, tc, lens, 8)
    _close_cache(tc, jc, _close_drift, _close_drift)


def test_padded_prefill_matches_exact(pair):
    """Prompts padded up to the window's rung give the logits and leave the
    cache of the same prompts prefilled at their exact lengths (masked SSD
    gates, per-sample conv state; K/V rows past the prompt hold the
    padding's), in the port as in the compiled reference."""
    name, (jm, jp, tm, tp) = pair
    cfg = configs(name)[1]
    rng = np.random.default_rng(3)
    for n in (5, 8):          # inside the first chunk of h5, and a whole one
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = prompt
        tl_pad, tc_pad = tm.prefill(
            tp, {"tokens": torch.from_numpy(padded),
                 "lengths": torch.tensor([n], dtype=torch.int32)})
        tl_ex, tc_ex = tm.prefill(tp,
                                  {"tokens": torch.from_numpy(prompt[None])})
        _close_bf16(tl_pad, tl_ex)
        for leaf in ("conv_g", "conv_w"):
            _close_bf16(tc_pad[leaf], tc_ex[leaf])
        for leaf in STATE_LEAVES:
            _close_state(tc_pad[leaf], tc_ex[leaf])
        for leaf in ("kg", "vg", "kw", "vw"):
            _close_bf16(tc_pad[leaf][:, :, :n], tc_ex[leaf][:, :, :n])
        assert tc_pad["lengths"].tolist() == tc_ex["lengths"].tolist() == [n]
        jl_pad, _ = _jit_prefill(jm, jp, padded, np.array([n], np.int32))
        (np.testing.assert_array_equal if name == "h2" else _close_drift)(
            f32(tl_pad), f32(jl_pad))


def test_padded_prefill_past_the_window_raises(pair):
    """A padded bucket longer than the window would wrap junk onto live
    ring slots; the reference asserts, the port raises."""
    _, (_, _, tm, tp) = pair
    toks = torch.zeros((1, 24), dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        tm.prefill(tp, {"tokens": toks,
                        "lengths": torch.tensor([20], dtype=torch.int32)})


def test_decode_step_from_the_reference_cache_in_place(pair):
    """One decode step, both from the reference's prefill cache (the
    port's copy bridged bit for bit; lengths 16, 11, 5, so the ring and
    global rows land mid-cache), held to the drift bound: the SSD state
    update's exp and log differ by an ulp between the libraries, which
    the bf16 read-out ``q . S`` can turn into a one-ulp flip. The fused
    engine step discards the cache ``decode_step`` returns, so the step
    must write every leaf of the cache it is given: each comes back as the
    same tensor, changed."""
    name, (jm, jp, tm, tp) = pair
    toks, lens = _prompts(configs(name)[1])
    _, jc = _jit_prefill(jm, jp, toks, lens)
    tc = _bridged(jc)
    before = {k: t.clone() for k, t in tc.items()}
    ids = {k: id(t) for k, t in tc.items() if k != "lengths"}
    nxt = np.array([[1], [2], [3]], np.int32)
    tl, out = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                             torch.from_numpy(lens))
    jl, jout = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt),
                                       jnp.asarray(lens))
    _close_drift(tl, jl)
    _close_cache(out, jout, _close_drift, _close_drift)
    assert {k: id(out[k]) for k in ids} == ids
    for k in ids:
        assert not torch.equal(tc[k], before[k]), k
    assert tc["lengths"].tolist() == lens.tolist()    # the input, untouched
    assert out["lengths"].tolist() == (lens + 1).tolist()


def test_decode_step_rounds_as_the_compiled_reference(pair):
    """Three decode steps, each from the reference's own cache bridged bit
    for bit, fed seeded tokens on which no last-ulp difference of the two
    libraries crosses a bf16 rounding: the logits and every bf16 leaf
    equal the compiled reference's bit for bit, the fp32 SSD states within
    16 fp32 ulps. This holds the decode step's rounding points: at h5 the
    last layer is an unrolled global layer, whose residual add the
    compiled reference fuses into the final norm (``add_rmsnorm`` here);
    with a rounded sum instead, 401 of these 768 logits differ."""
    name, (jm, jp, tm, tp) = pair
    toks, lens = _prompts(configs(name)[1])
    _, jc = _jit_prefill(jm, jp, toks, lens)
    step = jax.jit(jm.decode_step)
    rng = np.random.default_rng(7)
    for n in range(3):
        nxt = rng.integers(0, tm.cfg.vocab_size, size=(3, 1)).astype(np.int32)
        tl, out = tm.decode_step(tp, _bridged(jc), torch.from_numpy(nxt),
                                 torch.from_numpy(lens + n))
        jl, jc = step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens + n))
        np.testing.assert_array_equal(f32(tl), f32(jl))
        for k in BF16_LEAVES:
            np.testing.assert_array_equal(f32(out[k]), f32(jc[k]))
        _close_cache(out, jc)


def test_cache_scatter_matches_reference(pair):
    """``batched_scatter`` (the fused engine's admission) and
    ``_scatter_cache`` (the reference loop's) over hymba's cache: the
    reference's prefilled batch of 3, bridged, into slots 3, 1 and 0 of a
    4-slot cache; every leaf equals the reference's scatter of the same
    arrays bit for bit."""
    name, (jm, jp, tm, tp) = pair
    toks, lens = _prompts(configs(name)[1])
    _, jpc = _jit_prefill(jm, jp, toks, lens)
    tpc = _bridged(jpc)
    dst = [3, 1, 0]
    mask = np.isin(np.arange(4), dst)
    src = np.zeros(4, np.int32)
    src[dst] = [0, 1, 2]
    jcache = jm.init_cache(4, MAX_LEN)
    want = jax_engine.batched_scatter(jcache, jpc, jnp.asarray(mask),
                                      jnp.asarray(src))
    jloop = jcache
    fused, loop = tm.init_cache(4, MAX_LEN), tm.init_cache(4, MAX_LEN)
    batched_scatter(fused, tpc, torch.tensor(dst), torch.tensor([0, 1, 2]))
    for i, s in enumerate(dst):
        _scatter_cache(loop, tpc, i, s)
        jloop = jax_engine._scatter_cache(jloop, jpc, i, s)
    for got, ref in ((fused, want), (loop, jloop)):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == tpc[k].dtype
            np.testing.assert_array_equal(f32(got[k]), f32(ref[k]))


def test_one_host_copy_per_decode_step(monkeypatch):
    """A decode step calls no tensor-to-host method but the one ``.cpu()``
    of the packed ``[tokens || done]`` (and ``.numpy()`` on that host
    copy); prompts of 5, 9 and 17 tokens, the last on the exact path."""
    _, _, tm, tp = build_pair("h2")
    assert_one_host_copy_per_step(monkeypatch, tm, tp)


def test_full_config_builds_on_the_card_or_raises(monkeypatch):
    """``build_model`` of full-width hymba-1.5b defaults to the card and
    raises without one; with ``device="cpu"`` it builds the plain path
    (building allocates no weights)."""
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.models.api import build_model

    cfg = ARCHITECTURES["hymba-1.5b"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    assert model.extras["segments"] == [14, 15, 0]
    assert model.extras["prompt_pad_cap"] == 2048


@pytest.mark.parametrize("lengths", [[0, 3, 15, 16], [16, 17, 40, 31]])
def test_ring_helpers_match_reference(lengths):
    """``ring_cache_update`` writes at ``lengths % W`` in place and
    ``attention_decode_ring`` attends to ``min(lengths + 1, W)`` slots, as
    the reference's (its jnp decode attention, within one bf16 rounding);
    before the ring fills and after it has wrapped."""
    rng = np.random.default_rng(9)
    B, W, Hq, Hkv, D = 4, 16, 4, 2, 16

    def pair_of(shape):
        a = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
        return a, torch.from_numpy(f32(a)).to(torch.bfloat16)

    jk, tk = pair_of((B, W, Hkv, D))
    jv, tv = pair_of((B, W, Hkv, D))
    jkn, tkn = pair_of((B, 1, Hkv, D))
    jvn, tvn = pair_of((B, 1, Hkv, D))
    jq, tq = pair_of((B, 1, Hq, D))
    jl = jnp.asarray(lengths, jnp.int32)
    tl = torch.tensor(lengths, dtype=torch.int32)
    jk, jv = JC.ring_cache_update(jk, jv, jkn, jvn, jl)
    k_before = tk
    TC.ring_cache_update(tk, tv, tkn, tvn, tl)
    assert tk is k_before
    np.testing.assert_array_equal(f32(tk), f32(jk))
    np.testing.assert_array_equal(f32(tv), f32(jv))
    out = TC.attention_decode_ring(tq, tk, tv, tl)
    _close_bf16(out, JC.attention_decode_ring(jq, jk, jv, jl))
