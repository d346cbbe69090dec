"""xlstm (ssm family) parity: the port against the JAX package on bridged
weights.

Reduced xlstm-125m (1 pair, d_model 64, 4 heads, hd 32), bf16 with fp32
gate weights, built with chunk 8 (a 16-token prompt spans two chunks, so the
carried state crosses a chunk boundary) and with the default chunk 256.

Tolerances: logits to one bf16 rounding (rtol 2**-7), since the port rounds
where the reference rounds and the two libraries only sum fp32 products in
other orders; the fp32 state leaves (mLSTM matrix memory and normalizer,
sLSTM c, n, h, m) to rtol 1e-5 plus 2e-6 of the leaf's largest magnitude
(about 16 fp32 ulps of it), the spread of those summation orders. Decode
steps feed both the same tokens and are held to two bf16 roundings of the
largest logit, with the same greedy choice; the state after them to 1e-4 of
its magnitude (stated at the check)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import XLSTM_CONFIGS, build_pair, configs, f32, mesh_rules
from test_torch_serving import (
    _drive, assert_one_host_copy_per_step, assert_reports_match)

from repro.core.metrics import VirtualClock
from repro.serving.engine import LMServer as JLMServer
from repro.workloads.scenario import SCENARIOS, ScenarioRunner
from repro_torch.core.metrics import VirtualClock as TVirtualClock
from repro_torch.serving.engine import LMServer, batched_scatter

BF16_ULP = 2.0 ** -7
MAX_LEN = 48


@pytest.fixture(scope="module", params=XLSTM_CONFIGS)
def pair(request):
    return request.param, build_pair(request.param)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    lens = np.array([16, 11, 5], np.int32)
    return toks, lens


def _leaves(cache):
    """The state leaves of an xlstm cache, in a fixed order."""
    return [cache["m"][0], cache["m"][1], *cache["s"]]


def _close_logits(t, j):
    np.testing.assert_allclose(f32(t), f32(j), rtol=BF16_ULP, atol=1e-6)


def _close_state(t, j, rel=2e-6):
    j = f32(j)
    np.testing.assert_allclose(f32(t), j, rtol=1e-5,
                               atol=rel * max(float(np.abs(j).max()), 1.0))


def _prefill_both(jm, jp, tm, tp, toks, lens):
    jl, jc = jax.jit(lambda p, t, l: jm.prefill(
        p, {"tokens": t, "lengths": l}, max_len=MAX_LEN))(jp, toks, lens)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)},
                        max_len=MAX_LEN)
    return jl, jc, tl, tc


def test_seeded_init_matches_reference_tree(pair):
    """Same tree, shapes and dtypes as the reference (fp32 gate weights),
    and the same values for the same seed."""
    _, (jm, jp, tm, tp) = pair
    p0 = tm.init(torch.Generator().manual_seed(0))
    p1 = tm.init(torch.Generator().manual_seed(0))
    ref = jax.tree.leaves(jp)
    assert len(jax.tree.leaves(p0)) == len(ref) == 16
    for a, b, r in zip(jax.tree.leaves(p0), jax.tree.leaves(p1), ref):
        assert tuple(a.shape) == r.shape
        assert a.dtype == (torch.float32 if r.dtype == np.float32
                           else torch.bfloat16)
        assert torch.equal(a, b)
    for name in ("w_gates", "b_gates"):
        assert p0["pairs"]["m"][name].dtype == torch.float32
        assert tp["pairs"]["m"][name].dtype == torch.float32
        np.testing.assert_array_equal(tp["pairs"]["m"][name].numpy(),
                                      np.asarray(jp["pairs"]["m"][name]))


def test_prefill_logits_and_state(pair):
    name, (jm, jp, tm, tp) = pair
    toks, lens = _prompts(configs(name)[1])
    jl, jc, tl, tc = _prefill_both(jm, jp, tm, tp, toks, lens)
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    _close_logits(tl, jl)
    jleaves = [jc["m"][0], jc["m"][1], *jc["s"]]
    for t, j in zip(_leaves(tc), jleaves, strict=True):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        _close_state(t, j)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_decode_logits_16_steps(pair):
    name, (jm, jp, tm, tp) = pair
    cfg = configs(name)[1]
    toks, lens = _prompts(cfg)
    jl, jc, tl, tc = _prefill_both(jm, jp, tm, tp, toks, lens)
    step = jax.jit(jm.decode_step)
    jlen = jnp.asarray(lens)
    tlen = torch.from_numpy(lens.copy())
    rng = np.random.default_rng(7)
    for _ in range(16):
        nxt = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nxt), jlen)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), tlen)
        scale = np.abs(f32(jl)).max()
        np.testing.assert_allclose(f32(tl), f32(jl), rtol=0,
                                   atol=2 * BF16_ULP * scale)
        np.testing.assert_array_equal(f32(tl).argmax(-1), f32(jl).argmax(-1))
        np.testing.assert_array_equal(tc["lengths"].numpy(),
                                      np.asarray(jc["lengths"]))
        jlen, tlen = jlen + 1, tlen + 1
    # each step writes k v^T and the sLSTM gates from bf16 GEMM outputs,
    # where one summation order can round an element the other way (one
    # bf16 ulp of k or v enters the state): 1e-4 of the leaf's magnitude
    for t, j in zip(_leaves(tc), [jc["m"][0], jc["m"][1], *jc["s"]]):
        _close_state(t, j, rel=1e-4)


def test_padded_prefill_matches_exact(pair):
    """Prompts padded up a ladder rung leave the state of the same prompts
    prefilled at their exact lengths (gate masking for mLSTM, carry-select
    for sLSTM) and give their logits, in the port as in the reference."""
    name, (jm, jp, tm, tp) = pair
    cfg = configs(name)[1]
    rng = np.random.default_rng(3)
    for n in (5, 8):          # inside the first chunk, and a whole chunk
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = prompt
        tl_pad, tc_pad = tm.prefill(
            tp, {"tokens": torch.from_numpy(padded),
                 "lengths": torch.tensor([n], dtype=torch.int32)})
        tl_ex, tc_ex = tm.prefill(tp, {"tokens": torch.from_numpy(prompt[None])})
        _close_logits(tl_pad, tl_ex)
        for a, b in zip(_leaves(tc_pad), _leaves(tc_ex), strict=True):
            _close_state(a, b)
        assert tc_pad["lengths"].tolist() == tc_ex["lengths"].tolist() == [n]
        jl_ex, jc_ex = jm.prefill(jp, {"tokens": jnp.asarray(prompt[None])})
        _close_logits(tl_ex, jl_ex)
        for a, b in zip(_leaves(tc_pad), [jc_ex["m"][0], jc_ex["m"][1],
                                          *jc_ex["s"]]):
            _close_state(a, b)


def test_decode_updates_the_cache_in_place(pair):
    """The fused engine step discards the cache ``decode_step`` returns, so
    the step must write every state leaf of the cache it is given. Each leaf
    comes back as the same tensor, changed, and equal to the reference's new
    state."""
    name, (jm, jp, tm, tp) = pair
    cfg = configs(name)[1]
    toks, lens = _prompts(cfg)
    _, jc, _, tc = _prefill_both(jm, jp, tm, tp, toks, lens)
    before = [t.clone() for t in _leaves(tc)]
    ids = [id(t) for t in _leaves(tc)]
    nxt = np.array([[1], [2], [3]], np.int32)
    _, out = tm.decode_step(tp, tc, torch.from_numpy(nxt),
                            torch.from_numpy(lens))
    _, jout = jm.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(lens))
    assert [id(t) for t in _leaves(out)] == ids
    jleaves = [jout["m"][0], jout["m"][1], *jout["s"]]
    for t, old, j in zip(_leaves(tc), before, jleaves, strict=True):
        assert not torch.equal(t, old)
        _close_state(t, j)


def test_batched_scatter_walks_tuples():
    """Slot rows land where ``dst`` says in every leaf of a dict-of-tuples
    cache ([L, B, ...] leaves and the [B] lengths)."""
    gen = torch.Generator().manual_seed(0)
    cache = {"m": (torch.zeros(2, 4, 3, 5), torch.zeros(2, 4, 3)),
             "s": tuple(torch.zeros(2, 4, 6) for _ in range(4)),
             "lengths": torch.zeros(4, dtype=torch.int32)}
    pcache = {"m": (torch.randn(2, 2, 3, 5, generator=gen),
                    torch.randn(2, 2, 3, generator=gen)),
              "s": tuple(torch.randn(2, 2, 6, generator=gen)
                         for _ in range(4)),
              "lengths": torch.tensor([7, 9], dtype=torch.int32)}
    batched_scatter(cache, pcache, torch.tensor([3, 1]), torch.tensor([0, 1]))
    for got, src in zip(jax.tree.leaves(cache), jax.tree.leaves(pcache)):
        if got.dim() == 1:
            assert got.tolist() == [0, 9, 0, 7]
            continue
        assert torch.equal(got[:, 3], src[:, 0])
        assert torch.equal(got[:, 1], src[:, 1])
        assert not got[:, 0].any() and not got[:, 2].any()


def test_calibrated_report_byte_identical():
    """The poisson scenario's arrivals and service model, served by both
    engines on reduced xlstm (chunk 8) with the same weights. The reports
    agree byte for byte except ``engine.attention_backend``, which names the
    implementation that ran (``"jnp"`` there, ``"plain"`` here)."""
    sc = SCENARIOS["poisson"]
    _, _, _, pending = ScenarioRunner(sc).build_lmserver()
    jm, jp, tm, tp = build_pair("x8")
    mesh, rules = mesh_rules()

    def service_model(kind: str, batch: int, tokens: int) -> float:
        if kind == "prefill":
            return sc.base_latency + sc.per_item_latency * batch * tokens
        return sc.base_latency / 4 + sc.per_item_latency * batch

    kw = dict(slots=sc.slots, max_len=64, slo=sc.slo, temperature=0.0,
              seed=sc.seed, service_model=service_model,
              model_id=tm.cfg.name)
    jclock, tclock = VirtualClock(), TVirtualClock()
    jsrv = JLMServer(jm, mesh, rules, clock=jclock, **kw)
    tsrv = LMServer(tm, device="cpu", clock=tclock, **kw)
    _drive(jsrv, jclock, jp, pending, sc.max_new_tokens)
    _drive(tsrv, tclock, tp, pending, sc.max_new_tokens)
    assert tsrv.stats["completed"] == len(pending)
    assert_reports_match(jsrv, tsrv)


def test_one_host_copy_per_decode_step(monkeypatch):
    """A decode step calls no tensor-to-host method but the one ``.cpu()``
    of the packed ``[tokens || done]`` (and ``.numpy()`` on that host
    copy)."""
    _, _, tm, tp = build_pair("x8")
    assert_one_host_copy_per_step(monkeypatch, tm, tp)
