"""encdec (seamless-m4t-medium backbone) parity: the port against the JAX
package on bridged weights.

Two configurations of ``_torch_parity``: ``ed2``, reduced as the JAX tests
reduce it (2 + 2 layers, d_model 64, 4 / 2 heads of 16), and ``ed1`` with
4 / 4 heads (MHA, the full model's grouping). Frames are seeded fp32
[B, 8, d] unless a test says otherwise.

Tolerances. The decode step starting from the reference's own cache is
bit for bit: that settles its rounding points (the self-attention residual
fused into ``ln_x``, the cross-attention residual into ``ln2``, as XLA
fuses them; the spelled-out silu; the bf16-rounded softmax scale). The
prefill is not bit for bit: on these inputs a few hundred of the cache's
elements differ by one bf16 rounding where the compiled reference rounds
elsewhere inside the encoder and the non-causal cross-attention (not
settled; the decode step, which uses neither, is exact). So prefill
logits and cache leaves, and free-running decode, are held to ``DRIFT``
bf16 roundings of their largest magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (bridged, build_pair, configs, f32, family_batch)

from repro.serving import engine as jax_engine
from repro.serving.engine import LMServer as JLMServer
from repro_torch.serving.engine import (LMServer, _scatter_cache,
                                        batched_scatter, make_fused_decode_fn)
from repro_torch.serving.sampler import sample

BF16_ULP = 2.0 ** -7
MAX_LEN = 48
LEAVES = ("k", "v", "ck", "cv")
# bf16 roundings of the largest magnitude by which a comparison that
# carries one-rounding differences may differ: about twice the largest seen
# over these tests (0.9, ed2's prefill logits)
DRIFT = 2


@pytest.fixture(scope="module", params=("ed2", "ed1"))
def pair(request):
    return request.param, build_pair(request.param)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    return rng, toks, np.array([16, 11, 5], np.int32)


def _within(t, j, drift=DRIFT):
    j = f32(j)
    np.testing.assert_allclose(f32(t), j, rtol=0,
                               atol=drift * BF16_ULP * np.abs(j).max())


def _prefill_both(jm, jp, tm, tp, jb, tb, max_len=MAX_LEN):
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(jp, jb)
    tl, tc = tm.prefill(tp, tb, max_len=max_len)
    return jl, jc, tl, tc


def test_seeded_init_matches_reference_tree(pair):
    """The reference's tree (embed, enc_norm, enc, dec with self and cross
    attention), shapes and dtypes; the same values for the same seed; the
    reference's weights bridged bit for bit."""
    _, (jm, jp, tm, tp) = pair
    p0 = tm.init(torch.Generator().manual_seed(0))
    p1 = tm.init(torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    ours = jax.tree_util.tree_flatten_with_path(p0)[0]
    assert [k for k, _ in ours] == [k for k, _ in flat]
    for (_, a), b, (_, r) in zip(ours, jax.tree.leaves(p1), flat):
        assert tuple(a.shape) == r.shape and a.dtype == torch.bfloat16
        assert torch.equal(a, b)
    for (_, t), (_, r) in zip(jax.tree_util.tree_flatten_with_path(tp)[0],
                              flat):
        np.testing.assert_array_equal(f32(t), f32(r))


def test_prefill_logits_and_cache(pair):
    """Ladder-padded decoder prompts of 16, 11 and 5 tokens over 8 frames:
    logits, self K/V, the memory's K/V (``ck``/``cv``) and lengths."""
    name, (jm, jp, tm, tp) = pair
    rng, toks, lens = _prompts(configs(name)[1])
    jb, tb = family_batch(tm.cfg, rng, toks, lens)
    jl, jc, tl, tc = _prefill_both(jm, jp, tm, tp, jb, tb)
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    _within(tl, jl)
    for key in LEAVES:
        assert tuple(tc[key].shape) == jc[key].shape
        _within(tc[key], jc[key])
    assert tuple(tc["ck"].shape)[2] == 8                # S_enc, not max_len
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_decode_step_from_the_reference_cache_is_bit_exact(pair):
    """Three decode steps, each from the reference's own cache (bridged):
    logits and the written K/V equal the compiled reference's bit for bit,
    and the memory's K/V are left as they were."""
    name, (jm, jp, tm, tp) = pair
    rng, toks, lens = _prompts(configs(name)[1])
    jb, _ = family_batch(tm.cfg, rng, toks, lens)
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=MAX_LEN))(jp, jb)
    step = jax.jit(jm.decode_step)
    for n in range(3):
        nxt = rng.integers(0, tm.cfg.vocab_size, size=(3, 1)).astype(np.int32)
        tc = bridged(jc)
        tl, out = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                 torch.from_numpy(lens + n))
        jl, jc = step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens + n))
        np.testing.assert_array_equal(f32(tl), f32(jl))
        for key in LEAVES:
            assert out[key] is tc[key]                   # in place
            np.testing.assert_array_equal(f32(out[key]), f32(jc[key]))
        np.testing.assert_array_equal(out["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))


def test_decode_16_steps(pair):
    """Sixteen teacher-forced decode steps, each side from its own
    prefill: logits within ``DRIFT`` roundings of the largest, and the
    greedy choice equal wherever the reference's best two logits are
    further apart than that."""
    name, (jm, jp, tm, tp) = pair
    rng, toks, lens = _prompts(configs(name)[1])
    jb, tb = family_batch(tm.cfg, rng, toks, lens)
    _, jc, _, tc = _prefill_both(jm, jp, tm, tp, jb, tb)
    step = jax.jit(jm.decode_step)
    for n in range(16):
        nxt = rng.integers(0, tm.cfg.vocab_size, size=(3, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens + n))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                torch.from_numpy(lens + n))
        _within(tl, jl)
        j = f32(jl)
        top2 = np.sort(j, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > DRIFT * BF16_ULP * np.abs(j).max()
        np.testing.assert_array_equal(f32(tl).argmax(-1)[clear],
                                      j.argmax(-1)[clear])
    for key in LEAVES:
        _within(tc[key], jc[key])


def test_decode_matches_prefill(pair):
    """``test_models_smoke.py::test_decode_matches_prefill`` for the port:
    teacher-forced decode of token S matches the prefill of S + 1 tokens
    (32 frames of N(0, 0.02**2)) within the reference's 0.1, and the
    port's decode logits are the reference's within ``DRIFT``."""
    _, (jm, jp, tm, tp) = pair
    rng = np.random.default_rng(0)
    S = 16
    toks = rng.integers(0, tm.cfg.vocab_size, (2, S + 1)).astype(np.int32)
    fr = (rng.normal(size=(2, 32, tm.cfg.d_model)) * 0.02).astype(np.float32)
    cap = S + 1
    full = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(fr)}
    pre = {"tokens": torch.from_numpy(toks[:, :S]),
           "frames": torch.from_numpy(fr)}
    lg_full, _ = tm.prefill(tp, full, max_len=cap)
    _, cache = tm.prefill(tp, pre, max_len=cap)
    lg_dec, _ = tm.decode_step(tp, cache, torch.from_numpy(toks[:, S:]),
                               cache["lengths"])
    assert float((lg_full.float() - lg_dec.float()).abs().max()) < 0.1
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                                "frames": jnp.asarray(fr)}, max_len=cap)
    jl, _ = jm.decode_step(jp, jcache, jnp.asarray(toks[:, S:]),
                           jcache["lengths"])
    _within(lg_dec, jl)


def test_fused_step_token_parity(pair):
    """``test_serving_fused.py::test_fused_step_token_parity_all_families
    [encdec]`` for the port: ``make_fused_decode_fn`` against a loop that
    keeps the per-slot bookkeeping on the host, from the same scattered
    cache (2 of 3 slots active, frames of 8 in a 32-row slot cache):
    tokens and done flags equal step for step."""
    _, (jm, jp, tm, tp) = pair
    rng = np.random.default_rng(3)
    slots, max_len, plen, max_new = 3, 32, 6, 5
    toks = rng.integers(0, tm.cfg.vocab_size, (2, plen)).astype(np.int32)
    _, tb = family_batch(tm.cfg, rng, toks, scale=0.02)
    logits, pcache = tm.prefill(tp, tb, max_len=max_len)
    first = sample(logits, None).tolist()

    def scattered():
        cache = tm.init_cache(slots, max_len)
        batched_scatter(cache, pcache, torch.tensor([0, 1]),
                        torch.tensor([0, 1]))
        return cache

    fused = make_fused_decode_fn(tm, temperature=0.0, eos=-1,
                                 max_len=max_len)
    cache = scattered()
    lengths = torch.tensor([plen, plen, 0], dtype=torch.int32)
    cur = torch.tensor([[first[0]], [first[1]], [0]], dtype=torch.int32)
    active = torch.tensor([True, True, False])
    gen = torch.tensor([1, 1, 0], dtype=torch.int32)
    maxn = torch.tensor([max_new, max_new, 0], dtype=torch.int32)
    fused_out = []
    for _ in range(max_new):
        out = fused(tp, cache, lengths, cur, active, gen, maxn).tolist()
        fused_out.append((out[:slots], [bool(x) for x in out[slots:]]))

    cache = scattered()
    lengths = torch.tensor([plen, plen, 0], dtype=torch.int32)
    cur = torch.tensor([[first[0]], [first[1]], [0]], dtype=torch.int32)
    live = {0: 1, 1: 1}
    ref_out = []
    for _ in range(max_new):
        lg, _ = tm.decode_step(tp, cache, cur, lengths)
        t = sample(lg, None).tolist()
        lengths = lengths + torch.tensor(
            [1 if s in live else 0 for s in range(slots)], dtype=torch.int32)
        done = [False] * slots
        for s in list(live):
            live[s] += 1
            cur[s, 0] = t[s]
            if live[s] >= max_new or int(lengths[s]) >= max_len - 1:
                done[s] = True
                del live[s]
        ref_out.append((t, done))
    for (ft, fd), (rt, rd) in zip(fused_out, ref_out):
        assert fd == rd
        assert ft[:2] == rt[:2]


def test_batched_scatter_matches_reference(pair):
    """``test_serving_fused.py::test_batched_scatter_matches_reference
    [encdec]`` for the port: the reference's prefill of 2 prompts over 8
    frames, bridged, into slots 2 and 0 of a 4-slot, 32-row cache. The
    memory's 8 rows fill each slot's first 8 and the other 24 are zero;
    ``batched_scatter`` and ``_scatter_cache`` give every leaf of the
    reference's scatters bit for bit, and overwrite a slot's stale rows."""
    _, (jm, jp, tm, tp) = pair
    rng = np.random.default_rng(4)
    slots, max_len, plen = 4, 32, 6
    toks = rng.integers(0, tm.cfg.vocab_size, (2, plen)).astype(np.int32)
    jb, _ = family_batch(tm.cfg, rng, toks, scale=0.02)
    _, jpc = jm.prefill(jp, jb, max_len=max_len)
    tpc = bridged(jpc)
    assert tuple(tpc["ck"].shape)[2] == 8
    ref = jm.init_cache(slots, max_len)
    ref = jax_engine._scatter_cache(ref, jpc, 0, 2)
    ref = jax_engine._scatter_cache(ref, jpc, 1, 0)
    want = jax_engine.batched_scatter(
        jm.init_cache(slots, max_len), jpc,
        jnp.asarray([True, False, True, False]),
        jnp.asarray([1, 0, 0, 0], jnp.int32))
    fused = tm.init_cache(slots, max_len)
    loop = tm.init_cache(slots, max_len)
    for c in (fused, loop):                  # stale rows a slot held before
        for key in LEAVES:
            c[key].fill_(1.0)
    batched_scatter(fused, tpc, torch.tensor([2, 0]), torch.tensor([0, 1]))
    _scatter_cache(loop, tpc, 0, 2)
    _scatter_cache(loop, tpc, 1, 0)
    for got in (fused, loop):
        for key in LEAVES:
            for s in (0, 2):
                np.testing.assert_array_equal(f32(got[key][:, s]),
                                              f32(want[key][:, s]))
                np.testing.assert_array_equal(f32(got[key][:, s]),
                                              f32(ref[key][:, s]))
            assert (f32(got[key][:, [1, 3]]) == 1.0).all()
        assert not f32(got["ck"][:, [0, 2], 8:]).any()
        np.testing.assert_array_equal(got["lengths"][[0, 2]].numpy(),
                                      np.asarray(want["lengths"])[[0, 2]])


def test_padded_prefill_matches_exact(pair):
    """``test_serving_fused.py::test_padded_prefill_matches_exact[encdec]``
    for the port: a 5-token prompt right-padded to 8 with ``lengths`` gives
    the exact prefill's logits and lengths bit for bit, and the same next
    decode step; the exact prefill is the reference's within ``DRIFT``."""
    _, (jm, jp, tm, tp) = pair
    rng = np.random.default_rng(5)
    L, Lb = 5, 8
    toks = rng.integers(0, tm.cfg.vocab_size, (2, L)).astype(np.int32)
    padded = np.zeros((2, Lb), np.int32)
    padded[:, :L] = toks
    fr = torch.from_numpy((rng.normal(size=(2, 8, tm.cfg.d_model))
                           * 0.02).astype(np.float32))
    le, ce = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "frames": fr},
                        max_len=32)
    lp, cp = tm.prefill(tp, {"tokens": torch.from_numpy(padded),
                             "lengths": torch.tensor([L, L],
                                                     dtype=torch.int32),
                             "frames": fr}, max_len=32)
    assert torch.equal(le, lp)
    assert torch.equal(ce["lengths"], cp["lengths"])
    t = le.float().argmax(-1).to(torch.int32)[:, None]
    l2e, _ = tm.decode_step(tp, ce, t, ce["lengths"])
    l2p, _ = tm.decode_step(tp, cp, t, cp["lengths"])
    assert torch.equal(l2e, l2p)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                            "frames": jnp.asarray(fr.numpy())}, max_len=32)
    _within(le, jl)


def test_cross_attention_weighs_padded_memory_rows(pair):
    """The reference's decode attends the memory with ``S_enc =
    ck.shape[1]``: scattered into a slot cache of ``max_len`` rows (``init
    _cache(slots, max_len)``, as admission makes it), an 8-frame memory is
    attended with its 24 zero rows too. The port does the same, bit for
    bit from the reference's scattered cache, and its logits differ from a
    decode against a cache of ``enc_len = 8``."""
    _, (jm, jp, tm, tp) = pair
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 6)).astype(np.int32)
    jb, _ = family_batch(tm.cfg, rng, toks, scale=0.5)
    _, jpc = jm.prefill(jp, jb, max_len=32)
    mask, src = jnp.asarray([True, True]), jnp.asarray([0, 1], jnp.int32)
    padded = jax_engine.batched_scatter(jm.init_cache(2, 32), jpc, mask, src)
    exact = jax_engine.batched_scatter(jm.init_cache(2, 32, enc_len=8), jpc,
                                       mask, src)
    nxt = rng.integers(0, tm.cfg.vocab_size, (2, 1)).astype(np.int32)
    outs = {}
    for kind, jc in (("padded", padded), ("exact", exact)):
        jl, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt),
                                        jc["lengths"])
        tc = bridged(jc)
        tl, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt), tc["lengths"])
        np.testing.assert_array_equal(f32(tl), f32(jl))
        outs[kind] = f32(tl)
    assert tuple(bridged(padded)["ck"].shape)[2] == 32
    assert np.abs(outs["padded"] - outs["exact"]).max() > 0.01
    # the port's own scatter into either slot cache gives the same leaves
    tpc = bridged(jpc)
    for jc, enc_len in ((padded, 0), (exact, 8)):
        tc = tm.init_cache(2, 32, enc_len=enc_len)
        batched_scatter(tc, tpc, torch.tensor([0, 1]), torch.tensor([0, 1]))
        for key in LEAVES:
            np.testing.assert_array_equal(f32(tc[key]), f32(jc[key]))


def test_neither_lmserver_serves_encdec(pair):
    """``LMServer.submit`` carries tokens only and the encdec prefill reads
    ``batch["frames"]``: both packages' servers raise ``KeyError:
    'frames'`` at the first admission."""
    _, (jm, jp, tm, tp) = pair
    from repro.core.metrics import VirtualClock
    from repro.distributed.sharding import serve_rules
    from repro.launch.mesh import compat_make_mesh
    from repro_torch.core.metrics import VirtualClock as TVirtualClock

    def service(kind, b, t):
        return 1e-3

    jsrv = JLMServer(jm, compat_make_mesh((1, 1), ("data", "model")),
                     serve_rules(False), max_len=32, clock=VirtualClock(),
                     service_model=service)
    tsrv = LMServer(tm, device="cpu", max_len=32, clock=TVirtualClock(),
                    service_model=service)
    for srv, params in ((jsrv, jp), (tsrv, tp)):
        srv.submit(np.arange(5), max_new_tokens=2)
        with pytest.raises(KeyError, match="frames"):
            srv.run(params)
