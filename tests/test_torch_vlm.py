"""vlm (internvl2-1b backbone) parity: the port's transformer with the
vision-prefix stub against the JAX package on bridged weights.

Two configurations of ``_torch_parity``: ``vl2``, reduced as the JAX tests
reduce it (2 layers, d_model 64, 4 / 2 heads of 16, 8 prefix embeddings),
and ``vl7`` with 7 / 1 heads of 16 (the full model's G = 7). Prefix
embeddings are seeded fp32 [B, 8, d], cast to bf16 and put ahead of the
text embeddings in prefill, as the reference does.

Tolerances. The two libraries' fp32 sums (GEMMs, softmax, RMSNorm) differ
in the last ulp, and now and then that flips a bf16 rounding, which later
layers pass on: prefill and decode logits and K/V, text-only (what
``LMServer`` serves, in both packages) and prefixed, are held to
``DRIFT`` bf16 roundings of their largest magnitude, and the greedy
choices must agree. Greedy ``LMServer`` streams follow the bf16 near-tie
rule of ``_torch_ties``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import bridged, build_pair, configs, f32, family_batch
from test_torch_serving import assert_greedy_streams_match

BF16_ULP = 2.0 ** -7
MAX_LEN = 48
# bf16 roundings of the largest magnitude by which logits and K/V may
# differ: about twice the largest seen (0.6, vl2's prefixed logits)
DRIFT = 2


@pytest.fixture(scope="module", params=("vl2", "vl7"))
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


def _jit_prefill(jm, max_len=MAX_LEN):
    return jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))


def test_seeded_init_matches_reference_tree(pair):
    """The dense tree (the vision frontend is a stub: no weights of its
    own), shapes and dtypes, the same values for the same seed, and the
    reference's weights bridged bit for bit."""
    _, (jm, jp, tm, tp) = pair
    p0 = tm.init(torch.Generator().manual_seed(0))
    p1 = tm.init(torch.Generator().manual_seed(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert ([k for k, _ in jax.tree_util.tree_flatten_with_path(p0)[0]]
            == [k for k, _ in flat])
    for a, b, (_, r) in zip(jax.tree.leaves(p0), jax.tree.leaves(p1), flat):
        assert tuple(a.shape) == r.shape and a.dtype == torch.bfloat16
        assert torch.equal(a, b)
    for t, (_, r) in zip(jax.tree.leaves(tp), flat):
        np.testing.assert_array_equal(f32(t), f32(r))


def _agree(tl, jl):
    """``tl`` within ``DRIFT`` of ``jl``, the same greedy choice."""
    _within(tl, jl)
    np.testing.assert_array_equal(f32(tl).argmax(-1), f32(jl).argmax(-1))


def test_text_prefill_and_decode(pair):
    """Text only, as ``LMServer`` serves the family: prompts of 16, 11 and
    5 tokens padded to 16, then four teacher-forced decode steps, each side
    from its own cache: logits and K/V within ``DRIFT``, the same greedy
    choices, lengths equal."""
    name, (jm, jp, tm, tp) = pair
    rng, toks, lens = _prompts(configs(name)[1])
    jb, tb = family_batch(tm.cfg, rng, toks, lens, frames=0)
    jl, jc = _jit_prefill(jm)(jp, jb)
    tl, tc = tm.prefill(tp, tb, max_len=MAX_LEN)
    step = jax.jit(jm.decode_step)
    for n in range(5):
        _agree(tl, jl)
        for key in ("k", "v"):
            _within(tc[key], jc[key])
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))
        nxt = rng.integers(0, tm.cfg.vocab_size, size=(3, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens + n))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                                torch.from_numpy(lens + n))


def test_prefixed_prefill_and_decode(pair):
    """8 prefix embeddings ahead of 16 text tokens (no ``lengths``, an
    exact batch): logits and K/V over all 24 positions within ``DRIFT``,
    cache lengths 24; then three decode steps, each from the reference's
    own cache, within ``DRIFT``."""
    name, (jm, jp, tm, tp) = pair
    rng, toks, _ = _prompts(configs(name)[1])
    jb, tb = family_batch(tm.cfg, rng, toks)
    assert tuple(tb["prefix_embeddings"].shape) == (3, 8, tm.cfg.d_model)
    jl, jc = _jit_prefill(jm)(jp, jb)
    tl, tc = tm.prefill(tp, tb, max_len=MAX_LEN)
    _agree(tl, jl)
    for key in ("k", "v"):
        _within(tc[key], jc[key])
        assert not f32(tc[key][:, :, 24:]).any()
    assert tc["lengths"].tolist() == [24] * 3 == np.asarray(
        jc["lengths"]).tolist()
    step = jax.jit(jm.decode_step)
    for n in range(3):
        nxt = rng.integers(0, tm.cfg.vocab_size, size=(3, 1)).astype(np.int32)
        rc = bridged(jc)
        tl, out = tm.decode_step(tp, rc, torch.from_numpy(nxt),
                                 rc["lengths"])
        jl, jc = step(jp, jc, jnp.asarray(nxt), jc["lengths"])
        _agree(tl, jl)
        for key in ("k", "v"):
            _within(out[key], jc[key])


def test_prefix_with_text_lengths_matches_reference(pair):
    """The reference's ``lengths`` count text tokens while its prefill
    masks keys (``kv_valid``) over the prefixed sequence: with a prefix
    and ``lengths``, the keys past ``lengths`` are masked though they are
    text, and the logits are read at row ``lengths - 1``, a prefix row.
    ``LMServer`` never sends a prefix, so no served run reaches this; the
    port does what the reference does, within ``DRIFT``."""
    name, (jm, jp, tm, tp) = pair
    rng, toks, lens = _prompts(configs(name)[1])
    jb, tb = family_batch(tm.cfg, rng, toks, lens)
    jl, jc = _jit_prefill(jm)(jp, jb)
    tl, tc = tm.prefill(tp, tb, max_len=MAX_LEN)
    _within(tl, jl)
    assert tc["lengths"].tolist() == lens.tolist()
    # the logits are those of prefix row lengths - 1: the same as a
    # prefill cut to its first ``lengths`` rows of prefix
    cut = dict(tb, prefix_embeddings=tb["prefix_embeddings"][2:, :5],
               tokens=tb["tokens"][2:, :0])
    cut.pop("lengths")
    cl, _ = tm.prefill(tp, cut, max_len=MAX_LEN)
    np.testing.assert_allclose(f32(cl[0]), f32(tl[2]), rtol=0,
                               atol=DRIFT * BF16_ULP * np.abs(f32(tl)).max())


def test_decode_matches_prefill(pair):
    """``test_models_smoke.py::test_decode_matches_prefill[internvl2-1b]``
    for the port: with 8 prefix embeddings of N(0, 0.02**2), teacher-forced
    decode of token S matches the prefill of S + 1 tokens within the
    reference's 0.1; the port's decode logits are the reference's within
    ``DRIFT``."""
    _, (jm, jp, tm, tp) = pair
    rng = np.random.default_rng(0)
    S = 16
    toks = rng.integers(0, tm.cfg.vocab_size, (2, S + 1)).astype(np.int32)
    emb = (rng.normal(size=(2, 8, tm.cfg.d_model)) * 0.02).astype(np.float32)
    cap = S + 1 + 8
    te = torch.from_numpy(emb)
    lg_full, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "prefix_embeddings": te}, max_len=cap)
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S]),
                               "prefix_embeddings": te}, max_len=cap)
    lg_dec, _ = tm.decode_step(tp, cache, torch.from_numpy(toks[:, S:]),
                               cache["lengths"])
    assert float((lg_full.float() - lg_dec.float()).abs().max()) < 0.1
    _, jcache = _jit_prefill(jm, cap)(
        jp, {"tokens": jnp.asarray(toks[:, :S]),
             "prefix_embeddings": jnp.asarray(emb)})
    jl, _ = jax.jit(jm.decode_step)(jp, jcache, jnp.asarray(toks[:, S:]),
                                    jcache["lengths"])
    _within(lg_dec, jl)


@pytest.mark.parametrize("seed", [11, 17])
def test_greedy_text_streams_match_reference(monkeypatch, pair, seed):
    """``LMServer``, text only as the reference serves the family: prompts
    of 3-39 tokens on the ladder, 8 new tokens; each stream is JAX's up to
    the first bf16 near-tie (``_torch_ties``)."""
    name, _ = pair
    assert_greedy_streams_match(monkeypatch, name, seed, fused=True)
