"""The Clipper frontend stack of the port against the JAX package.

Selection (Exp3/Exp4), the contextual store, straggler rendering and the
prediction cache go through both packages on the same seeded numpy inputs:
log-weights agree within 1e-6 absolute (fp32 softmax and logsumexp, whose
sums the two libraries may take in other orders), Exp3's chosen-model
stream and every cache decision are identical. The frontend stack of every
named scenario gives the reference's ``repro.metrics/v1`` report byte for
byte, and so do the span log, time series and audit documents of the traced
scenarios and the CLI's output. Then port-side copies of the reference's
unit tests (``test_selection``, ``test_context``, ``test_straggler``,
``test_cache``, ``test_frontend``, the frontend cases of
``test_workloads`` and the tracer cases of ``test_obs``), run against
``repro_torch`` with ``device="cpu"``."""

import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import cache as jcache
from repro.core import context as jcontext
from repro.core import selection as jsel
from repro.core import straggler as jstrag
from repro.core.metrics import MetricsRegistry as JMetrics
from repro.obs import AuditLog as JAuditLog
from repro.obs import BurnRateMonitor as JBurnRateMonitor
from repro.obs import FleetSampler as JFleetSampler
from repro.obs import Tracer as JTracer
from repro.workloads import run as jrun
from repro.workloads.scenario import SCENARIOS
from repro.workloads.scenario import ScenarioRunner as JRunner
from repro_torch.core import Feedback, linear_latency, make_clipper
from repro_torch.core import cache as tcache
from repro_torch.core import selection as tsel
from repro_torch.core import straggler as tstrag
from repro_torch.core.cache import ClockCache, PredictionCache, digest
from repro_torch.core.context import ContextualStore
from repro_torch.core.metrics import MetricsRegistry as TMetrics
from repro_torch.core.metrics import StreamingHistogram
from repro_torch.core.selection import (Exp3Policy, Exp4Policy, exp3_init,
                                        exp3_observe, exp3_probs,
                                        exp4_combine, exp4_init, exp4_observe,
                                        exp4_weights)
from repro_torch.core.straggler import (DeadlineTracker, agreement_confidence,
                                        assemble_preds)
from repro_torch.obs import (AuditLog, BurnRateMonitor, FleetSampler, Span,
                             SpanLog, Tracer, sample_decision)
from repro_torch.workloads import (Scenario, ScenarioRunner, poisson_trace,
                                   query_trace)
from repro_torch.workloads import run as trun
from repro_torch.workloads import run_scenario

CPU = "cpu"
ATOL = 1e-6


def assert_log_weights(got, want, *inputs):
    """Log-weights within 1e-6 absolute, plus two fp32 ulps of the largest
    magnitude among the update's input states and its result: the two
    libraries' fp32 ``exp`` and ``log`` inside logsumexp differ by up to an
    ulp, which at |log-weight| >= 8 is more than 1e-6 (ROADMAP.md §C). One
    update is compared at a time, from the same input state."""
    want = np.asarray(want)
    scale = max([float(np.abs(want).max())]
                + [float(np.abs(_np(x)).max()) for x in inputs])
    tol = ATOL + 2 * float(np.spacing(np.float32(scale)))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _log_weights(rng, k):
    """A seeded normalized log-weight state, one entry near the floor."""
    s = rng.normal(0, 3, size=k).astype(np.float32)
    s[rng.integers(k)] = -19.5
    return (s - np.log(np.exp(s.astype(np.float64)).sum())).astype(np.float32)


# ---------------------------------------------------------------------------
# selection against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eta", [0.1, 3.0])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_exp3_observe_matches_reference(k, eta):
    rng = np.random.default_rng(100 + k)
    s0 = _log_weights(rng, k)
    js = jnp.asarray(s0)
    for _ in range(60):
        c, loss = int(rng.integers(k)), np.float32(rng.random())
        s = np.asarray(js)
        js = jsel.exp3_observe(js, jnp.int32(c), jnp.float32(loss), eta)
        ts = exp3_observe(_t(s), torch.tensor(c), torch.tensor(loss), eta)
        assert_log_weights(ts, js, s)
    assert float(np.asarray(js).min()) >= tsel.LOG_WEIGHT_FLOOR
    assert tsel.LOG_WEIGHT_FLOOR == jsel.LOG_WEIGHT_FLOOR


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [2, 4, 7])
def test_exp4_observe_matches_reference(k, masked):
    rng = np.random.default_rng(200 + k)
    s0 = _log_weights(rng, k)
    js = jnp.asarray(s0)
    for _ in range(60):
        losses = rng.random(k).astype(np.float32)
        avail = rng.random(k) < 0.7 if masked else None
        s = np.asarray(js)
        js = jsel.exp4_observe(js, jnp.asarray(losses), 0.3,
                               None if avail is None else jnp.asarray(avail))
        ts = exp4_observe(_t(s), _t(losses), 0.3,
                          None if avail is None else _t(avail))
        assert_log_weights(ts, js, s)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(4, 10), (3, 2), (5,)])
def test_exp4_combine_matches_reference(shape, masked):
    rng = np.random.default_rng(sum(shape))
    k = shape[0]
    for _ in range(20):
        s = _log_weights(rng, k)
        preds = rng.random(shape).astype(np.float32)
        avail = None
        if masked:
            avail = rng.random(k) < 0.6
            avail[rng.integers(k)] = True
        jy, jc = jsel.exp4_combine(jnp.asarray(s), jnp.asarray(preds),
                                   None if avail is None
                                   else jnp.asarray(avail))
        ty, tc = exp4_combine(_t(s), _t(preds),
                              None if avail is None else _t(avail))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        assert float(tc) == float(jc)


def test_exp3_select_draws_from_the_exp3_distribution():
    """``exp3_select`` draws from softmax(s) with the caller's generator
    (the reference draws from ``jax.random``, which torch cannot
    reproduce: only the distribution is compared). 40k draws of a batch of
    states: frequencies within 0.01 of the probabilities; one seed, one
    draw."""
    s = torch.tensor([0.5, -1.0, 1.5, 0.0]).repeat(40_000, 1)
    gen = torch.Generator().manual_seed(0)
    picks = tsel.exp3_select(s, gen)
    freq = np.bincount(picks.numpy(), minlength=4) / len(picks)
    want = np.asarray(jsel.exp3_probs(jnp.asarray(s[0].numpy())))
    np.testing.assert_allclose(freq, want, atol=0.01)
    again = tsel.exp3_select(s[:50], torch.Generator().manual_seed(0))
    assert torch.equal(again, tsel.exp3_select(
        s[:50], torch.Generator().manual_seed(0)))


def test_exp3_policy_stream_matches_reference():
    """200 steps of select -> loss -> observe through both packages' Exp3
    policies, each on its own state and drawing from its own numpy generator
    with one seed: the same model every step. Each step's update, from the
    reference's state, agrees with the reference's (``assert_log_weights``);
    the two chains themselves drift apart by ulps that Exp3's 1 / p
    amplifies (ROADMAP.md §C), without changing a choice."""
    ids = ["m0", "m1", "m2", "m3"]
    err = np.array([0.6, 0.1, 0.4, 0.3])
    jp, tp = jsel.Exp3Policy(ids, eta=0.2), Exp3Policy(ids, eta=0.2,
                                                       device=CPU)
    js, ts = jp.init(), tp.init()
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    coins = np.random.default_rng(10).random(200)
    for step in range(200):
        (jm,), (tm,) = jp.select(js, None, jrng), tp.select(ts, None, trng)
        assert jm == tm, f"step {step}: {jm} vs {tm}"
        loss = float(coins[step] < err[ids.index(jm)])
        prev = np.asarray(js)
        js = jp.observe(js, None, {jm: loss}, None)
        ts = tp.observe(ts, None, {tm: loss}, None)
        assert_log_weights(tp.observe(_t(prev), None, {tm: loss}, None), js,
                           prev)
    np.testing.assert_allclose(_np(exp3_probs(ts)),
                               np.asarray(jsel.exp3_probs(js)), atol=1e-4)
    assert tp.host_copies == 200                  # one state read per select


def test_exp4_policy_matches_reference():
    ids = ["a", "b", "c"]
    jp, tp = jsel.Exp4Policy(ids, eta=0.4), Exp4Policy(ids, eta=0.4,
                                                       device=CPU)
    js, ts = jp.init(), tp.init()
    rng = np.random.default_rng(3)
    assert jp.select(js, None, rng) == tp.select(ts, None, rng) == ids
    for step in range(100):
        present = [m for m in ids if rng.random() < 0.8] or ["b"]
        preds = {m: rng.random(6).astype(np.float32) for m in present}
        jy, jc = jp.combine(js, None, preds)
        ty, tc = tp.combine(ts, None, preds)
        np.testing.assert_allclose(ty, jy, rtol=0, atol=ATOL)
        assert tc == jc
        losses = {m: float(rng.random()) for m in present}
        prev = np.asarray(js)
        js = jp.observe(js, None, losses, preds)
        ts = tp.observe(_t(prev), None, losses, preds)
        assert_log_weights(ts, js, prev)
    assert 0 < tp.host_copies <= 100              # one per multi-model combine


# ---------------------------------------------------------------------------
# the contextual store against the reference
# ---------------------------------------------------------------------------

def _observe(store, kind, users, rng, k):
    if kind == "exp3":
        chosen = rng.integers(k, size=len(users))
        losses = rng.random(len(users)).astype(np.float32)
        store[0].observe_exp3(users, chosen, losses)
        store[1].observe_exp3(users, chosen, losses)
    else:
        losses = rng.random((len(users), k)).astype(np.float32)
        avail = rng.random((len(users), k)) < 0.8
        store[0].observe_exp4(users, losses, avail)
        store[1].observe_exp4(users, losses, avail)


@pytest.mark.parametrize("kind", ["exp3", "exp4"])
def test_contextual_store_matches_reference_with_duplicates(kind):
    """Batches of 12 users out of 7 (ids up to 20, reduced modulo 7), so
    most batches name a user more than once: every row agrees with the
    reference's within 1e-6 after every batch."""
    k = 3
    pair = (jcontext.ContextualStore(7, k, kind=kind, eta=0.5),
            ContextualStore(7, k, kind=kind, eta=0.5, device=CPU))
    rng = np.random.default_rng(4)
    dup_batches = 0
    for _ in range(25):
        users = rng.integers(0, 21, size=12)
        dup_batches += len(np.unique(users % 7)) < len(users)
        prev = np.array(pair[0].states)
        pair[1].load_state_dict({"states": prev})
        _observe(pair, kind, users, rng, k)
        assert_log_weights(pair[1].states, pair[0].states, prev)
    assert dup_batches == 25
    for u in range(7):
        np.testing.assert_allclose(pair[1].probs_for(u),
                                   pair[0].probs_for(u), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["exp3", "exp4"])
def test_duplicate_users_last_occurrence_wins(kind):
    """Users [1, 1, 5] in a store of 4: all three rows are user 1, each
    update is computed from the state before the batch, and the third one
    lands, in the reference (XLA's CPU scatter) and in the port."""
    k = 3
    pair = (jcontext.ContextualStore(4, k, kind=kind, eta=0.5),
            ContextualStore(4, k, kind=kind, eta=0.5, device=CPU))
    rng = np.random.default_rng(5)
    _observe(pair, kind, np.array([1, 2]), rng, k)        # a nonzero start
    before = pair[1].states.clone()
    users = np.array([1, 1, 5])
    if kind == "exp3":
        chosen, losses = np.array([0, 2, 1]), np.array([0.9, 0.2, 0.7],
                                                        np.float32)
        for store in pair:
            store.observe_exp3(users, chosen, losses)
        want = exp3_observe(before[1], torch.tensor(1), torch.tensor(
            losses[2]), 0.5)
    else:
        losses = rng.random((3, k)).astype(np.float32)
        for store in pair:
            store.observe_exp4(users, losses)
        want = exp4_observe(before[1], _t(losses[2]), 0.5)
    np.testing.assert_array_equal(_np(pair[1].states[1]), _np(want))
    assert_log_weights(pair[1].states, pair[0].states, before)
    np.testing.assert_array_equal(_np(pair[1].states[[0, 2, 3]]),
                                  _np(before[[0, 2, 3]]))


def test_contextual_state_dict_round_trips_with_the_reference():
    pair = (jcontext.ContextualStore(5, 2), ContextualStore(5, 2,
                                                            device=CPU))
    rng = np.random.default_rng(6)
    _observe(pair, "exp4", np.array([0, 3, 3, 4]), rng, 2)
    d = pair[1].state_dict()
    assert d["kind"] == "exp4" and d["eta"] == 0.1
    back = ContextualStore(5, 2, device=CPU)
    back.load_state_dict(d)
    np.testing.assert_array_equal(_np(back.states), d["states"])
    ref = jcontext.ContextualStore(5, 2)
    ref.load_state_dict(d)                       # the port's dict, read there
    np.testing.assert_array_equal(np.asarray(ref.states), d["states"])
    back.load_state_dict(pair[0].state_dict())   # and the reference's here
    np.testing.assert_array_equal(_np(back.states),
                                  np.asarray(pair[0].states))
    # the dict is a snapshot: later feedback does not write through it
    snap = d["states"].copy()
    pair[1].observe_exp4(np.array([0]), np.array([[0.9, 0.0]]))
    np.testing.assert_array_equal(d["states"], snap)
    with pytest.raises(ValueError):
        back.load_state_dict({"states": np.zeros((4, 2))})


def test_contextual_combine_for_matches_reference():
    pair = (jcontext.ContextualStore(3, 4), ContextualStore(3, 4,
                                                            device=CPU))
    rng = np.random.default_rng(7)
    _observe(pair, "exp4", np.array([0, 1, 2]), rng, 4)
    preds = rng.random((4, 5)).astype(np.float32)
    avail = np.array([True, False, True, True])
    jy, jc = pair[0].combine_for(4, preds, avail)
    ty, tc = pair[1].combine_for(4, preds, _t(avail))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=0, atol=ATOL)
    assert float(tc) == float(jc)


# ---------------------------------------------------------------------------
# stragglers and the cache against the reference
# ---------------------------------------------------------------------------

def _ragged_preds(rng, ids, shape):
    return {m: rng.random(shape).astype(np.float32) for m in ids
            if rng.random() < 0.6}


@pytest.mark.parametrize("shape", [(5,), (3, 4), ()])
def test_straggler_math_matches_reference(shape):
    rng = np.random.default_rng(len(shape) + 11)
    ids = [f"m{i}" for i in range(7)]
    for _ in range(30):
        preds = _ragged_preds(rng, ids, shape)
        if not preds:
            with pytest.raises(ValueError):
                assemble_preds(ids, preds, device=CPU)
            continue
        jm, ja = jstrag.assemble_preds(ids, preds)
        tm, ta = assemble_preds(ids, preds, device=CPU)
        np.testing.assert_array_equal(_np(tm), np.asarray(jm))
        np.testing.assert_array_equal(_np(ta), np.asarray(ja))
        without = [m for m in preds if rng.random() < 0.3][:len(preds) - 1]
        np.testing.assert_array_equal(
            tstrag.render_without(ids, preds, without),
            jstrag.render_without(ids, preds, without))
        if len(shape) == 1:                        # [k, C] class scores
            assert (agreement_confidence(tm, ta)
                    == jstrag.agreement_confidence(jm, ja))


def test_cache_decisions_match_reference():
    """``digest`` of arrays, scalars and containers, and a ClockCache's
    hit / miss / eviction sequence under a seeded Zipf stream, equal the
    reference's; a PredictionCache counts the same hits into its registry."""
    rng = np.random.default_rng(12)
    inputs = [rng.random(4).astype(np.float32), rng.random((2, 3)), 1, 1.0,
              True, "x", (1, 2.0), [np.arange(3), ("a", 0)], None]
    for x in inputs:
        assert tcache.digest(x) == jcache.digest(x)
    caches = (jcache.ClockCache(6), ClockCache(6))
    for key in rng.zipf(1.4, size=500) % 40:
        got = [c.request(int(key)) for c in caches]
        assert got[0] == got[1]
        if not got[0]:
            for c in caches:
                c.put(int(key), int(key) * 3)
        assert list(caches[0]._slots) == list(caches[1]._slots)
        assert caches[0]._hand == caches[1]._hand
    assert ((caches[0].hits, caches[0].misses, caches[0].evictions)
            == (caches[1].hits, caches[1].misses, caches[1].evictions))
    pcs = (jcache.PredictionCache(8, metrics=JMetrics(0.02)),
           PredictionCache(8, metrics=TMetrics(0.02)))
    pool = [rng.random(3).astype(np.float32) for _ in range(12)]
    for i in rng.integers(0, 12, size=200):
        for pc in pcs:
            if not pc.request("m", pool[i]):
                pc.put("m", pool[i], i)
    assert (json.dumps(pcs[0].metrics.report("frontend"), sort_keys=True)
            == json.dumps(pcs[1].metrics.report("frontend"), sort_keys=True))


# ---------------------------------------------------------------------------
# the frontend stack of every named scenario, and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_frontend_scenario_report_byte_identical(name):
    want = JRunner(SCENARIOS[name]).run_json("frontend")
    assert ScenarioRunner(SCENARIOS[name], device=CPU).run_json(
        "frontend") == want


@pytest.mark.parametrize("name", ["poisson", "stragglers"])
def test_traced_frontend_documents_byte_identical(name):
    """A tracer, a fleet sampler with its burn-rate monitor and an audit
    log attached, built as ``obs/cli.py::build_fleet`` builds them: the
    report, span log, time series and audit documents equal the
    reference's byte for byte."""
    docs = []
    for runner, tracer, sampler, monitor, audit, kw in (
            (JRunner, JTracer, JFleetSampler, JBurnRateMonitor, JAuditLog,
             {}),
            (ScenarioRunner, Tracer, FleetSampler, BurnRateMonitor, AuditLog,
             {"device": CPU})):
        sc = SCENARIOS[name]
        tr = tracer(sample_rate=1.0, seed=sc.seed)
        sa = sampler(interval=0.05, monitor=monitor())
        au = audit()
        rep = runner(sc, tracer=tr, sampler=sa, audit=au, **kw).run_json(
            "frontend")
        docs.append((rep, tr.to_json(), sa.to_json(), au.to_json()))
    for j, t, what in zip(*docs, ("report", "spans", "series", "audit")):
        assert t == j, what
    assert len(json.loads(docs[1][1])["spans"]) > 0


@pytest.mark.parametrize("fleet", [False, True])
def test_cli_writes_what_the_reference_writes(tmp_path, fleet):
    """The reference's CLI and the port's (``--device cpu``), in process,
    with and without the trace, time-series and audit outputs: the same
    files, byte for byte."""
    outs = ("report", "trace", "series", "audit") if fleet else ("report",)
    for tag, main, dev in (("j", jrun.main, []),
                           ("t", trun.main, ["--device", "cpu"])):
        files = {o: str(tmp_path / f"{tag}.{o}.json") for o in outs}
        args = ["--scenario", "poisson", "--stack", "frontend",
                "--out", files["report"]] + dev
        if fleet:
            args += ["--seed", "7", "--duration", "0.5",
                     "--trace-out", files["trace"],
                     "--timeseries-out", files["series"],
                     "--audit-out", files["audit"]]
        assert main(args) == 0
    for o in outs:
        assert ((tmp_path / f"t.{o}.json").read_bytes()
                == (tmp_path / f"j.{o}.json").read_bytes()), o


def test_entry_points_run_on_the_card_or_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"m": lambda x: np.zeros((len(x), 2), np.float32)}
    with pytest.raises(RuntimeError, match="cuda"):
        make_clipper(fn)
    with pytest.raises(RuntimeError, match="cuda"):
        ScenarioRunner(SCENARIOS["poisson"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_scenario("poisson")
    with pytest.raises(RuntimeError, match="cuda"):
        ContextualStore(4, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--scenario", "poisson", "--out",
                   str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
    with pytest.raises(SystemExit):                  # no such device
        trun.main(["--device", "meta"])
    with pytest.raises(ValueError):
        ContextualStore(4, 2, device="meta")
    clip = make_clipper(fn, device=CPU)
    assert clip.policy_state.device.type == "cpu"


def test_container_copies_a_tensor_result_to_the_host_inside_the_window(
        monkeypatch):
    """Wall-clock mode (no latency model): the measured service time ends
    after the result reached the host. A predict function returns a tensor
    whose host copy takes one tick of the container's clock: that tick is
    in the measurement."""
    from repro_torch.core import containers
    ticks = iter(range(100))
    monkeypatch.setattr(containers, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))

    class SlowCopy(torch.Tensor):
        def cpu(self):
            next(ticks)
            return torch.Tensor.cpu(self)

    c = containers.TorchModelContainer(
        "m", lambda x: torch.as_tensor(x * 2).as_subclass(SlowCopy))
    ys, service = c.pred_batch_timed([np.ones(2, np.float32)] * 3)
    assert service == 2.0
    assert len(ys) == 3 and isinstance(ys[0], np.ndarray)
    np.testing.assert_array_equal(ys[2], [2.0, 2.0])
    assert c.stats.queries == 3 and c.stats.busy_time == 2.0


# ---------------------------------------------------------------------------
# port-side copies of tests/test_selection.py
# ---------------------------------------------------------------------------

def test_exp3_converges_to_best_model():
    rng = np.random.default_rng(0)
    err = np.array([0.5, 0.1, 0.4])           # model 1 is best
    s = exp3_init(3, CPU)
    for _ in range(2000):
        p = exp3_probs(s).numpy()
        i = rng.choice(3, p=p / p.sum())
        loss = float(rng.random() < err[i])
        s = exp3_observe(s, torch.tensor(i), torch.tensor(loss), eta=0.1)
    assert int(np.argmax(exp3_probs(s).numpy())) == 1
    assert float(exp3_probs(s)[1]) > 0.6


def test_exp4_downweights_failing_model():
    """Paper Fig 8: a degraded model loses its ensemble weight."""
    s = exp4_init(2, CPU)
    for _ in range(300):
        s = exp4_observe(s, torch.tensor([0.9, 0.05]), eta=0.1)
    w = exp4_weights(s).numpy()
    assert w[1] > 0.95


def test_exp4_recovers_after_model_heals():
    """Recovery is gradual (paper Fig 8): the weight gap accumulated during
    the failure window must be won back at the healthy loss differential."""
    s = exp4_init(2, CPU)
    for _ in range(200):                       # model 0 degraded
        s = exp4_observe(s, torch.tensor([0.9, 0.2]), eta=0.1)
    assert exp4_weights(s).numpy()[0] < 0.1
    for _ in range(1500):                      # model 0 recovers, now best
        s = exp4_observe(s, torch.tensor([0.05, 0.2]), eta=0.1)
    assert exp4_weights(s).numpy()[0] > 0.6


def test_exp4_combine_confidence_agreement():
    s = exp4_init(3, CPU)
    agree = torch.tensor([[0.1, 0.9], [0.2, 0.8], [0.3, 0.7]])
    y, conf = exp4_combine(s, agree)
    assert int(torch.argmax(y)) == 1 and conf == 1.0
    split = torch.tensor([[0.9, 0.1], [0.2, 0.8], [0.3, 0.7]])
    y2, conf2 = exp4_combine(s, split)
    assert conf2 < 1.0


def test_exp4_combine_masked_straggler():
    """§5.2.2: missing models are excluded from weights and confidence."""
    s = exp4_init(3, CPU)
    preds = torch.tensor([[0.9, 0.1], [0.0, 0.0], [0.8, 0.2]])
    avail = torch.tensor([True, False, True])
    y, conf = exp4_combine(s, preds, avail)
    assert int(torch.argmax(y)) == 0
    assert conf == 1.0                        # both available models agree


@given(st.integers(2, 8), st.lists(st.floats(0.0, 1.0), min_size=2,
                                   max_size=8))
@settings(max_examples=50, deadline=None)
def test_exp_weights_remain_simplex(k, losses):
    losses = (losses + [0.0] * k)[:k]
    s = exp4_init(k, CPU)
    for _ in range(5):
        s = exp4_observe(s, torch.tensor(losses, dtype=torch.float32))
    w = exp4_weights(s).numpy()
    assert np.all(w >= 0) and abs(w.sum() - 1.0) < 1e-5
    p = exp3_probs(exp3_observe(exp3_init(k, CPU), torch.tensor(0),
                                torch.tensor(losses[0]))).numpy()
    assert np.all(p >= 0) and abs(p.sum() - 1.0) < 1e-5


def test_policy_objects_listing2_interface():
    rng = np.random.default_rng(0)
    p3 = Exp3Policy(["a", "b"], device=CPU)
    s = p3.init()
    chosen = p3.select(s, None, rng)
    assert len(chosen) == 1 and chosen[0] in ("a", "b")
    p4 = Exp4Policy(["a", "b"], device=CPU)
    s4 = p4.init()
    assert p4.select(s4, None, rng) == ["a", "b"]
    y, conf = p4.combine(s4, None, {"a": np.array([1.0, 0.0]),
                                    "b": np.array([0.8, 0.2])})
    assert int(np.argmax(y)) == 0 and 0 < conf <= 1.0


# ---------------------------------------------------------------------------
# port-side copies of tests/test_context.py
# ---------------------------------------------------------------------------

def test_per_user_isolation_exp4():
    store = ContextualStore(num_users=4, k=2, kind="exp4", eta=0.3,
                            device=CPU)
    # user 0 sees model 0 failing; user 1 sees model 1 failing
    for _ in range(50):
        store.observe_exp4(np.array([0]), np.array([[0.9, 0.0]]))
        store.observe_exp4(np.array([1]), np.array([[0.0, 0.9]]))
    w0 = torch.softmax(store.state_for(0), -1).numpy()
    w1 = torch.softmax(store.state_for(1), -1).numpy()
    assert w0[1] > 0.9 and w1[0] > 0.9
    w2 = torch.softmax(store.state_for(2), -1).numpy()  # untouched: uniform
    np.testing.assert_allclose(w2, [0.5, 0.5], atol=1e-6)


def test_batched_update_matches_sequential():
    a = ContextualStore(num_users=8, k=3, kind="exp4", eta=0.1, device=CPU)
    b = ContextualStore(num_users=8, k=3, kind="exp4", eta=0.1, device=CPU)
    losses = np.array([[0.1, 0.5, 0.9], [0.9, 0.5, 0.1], [0.4, 0.4, 0.4]])
    users = np.array([2, 5, 7])
    a.observe_exp4(users, losses)
    for u, l in zip(users, losses):
        b.observe_exp4(np.array([u]), l[None])
    np.testing.assert_allclose(a.states.numpy(), b.states.numpy(),
                               atol=1e-6)


def test_exp3_contextual_update():
    store = ContextualStore(num_users=2, k=2, kind="exp3", eta=0.5,
                            device=CPU)
    for _ in range(30):
        store.observe_exp3(np.array([0]), np.array([0]), np.array([1.0]))
    p = store.probs_for(0)
    assert p[0] < 0.3                      # model 0 repeatedly penalized


def test_state_dict_roundtrip():
    store = ContextualStore(num_users=4, k=2, device=CPU)
    store.observe_exp4(np.array([1]), np.array([[0.9, 0.0]]))
    d = store.state_dict()
    store2 = ContextualStore(num_users=4, k=2, device=CPU)
    store2.load_state_dict(d)
    np.testing.assert_allclose(store.states.numpy(), store2.states.numpy())


# ---------------------------------------------------------------------------
# port-side copies of tests/test_straggler.py
# ---------------------------------------------------------------------------

def test_assemble_mean_substitution():
    preds = {"a": np.array([1.0, 0.0]), "c": np.array([0.0, 1.0])}
    mat, avail = assemble_preds(["a", "b", "c"], preds, device=CPU)
    assert avail.tolist() == [True, False, True]
    np.testing.assert_allclose(mat[1].numpy(), [0.5, 0.5])


def test_assemble_all_missing_raises():
    with pytest.raises(ValueError):
        assemble_preds(["a"], {}, device=CPU)


def test_agreement_confidence():
    mat = torch.tensor([[0.9, 0.1], [0.8, 0.2], [0.1, 0.9]])
    avail = torch.tensor([True, True, True])
    assert abs(agreement_confidence(mat, avail) - 2 / 3) < 1e-6
    avail2 = torch.tensor([True, True, False])
    assert agreement_confidence(mat, avail2) == 1.0


def test_deadline_tracker():
    d = DeadlineTracker(0.02)
    assert d.deadline_for(1.0) == 1.02
    assert not d.expired(1.0, 1.01)
    assert d.expired(1.0, 1.03)
    assert abs(d.remaining(1.0, 1.005) - 0.015) < 1e-9


# ---------------------------------------------------------------------------
# port-side copies of tests/test_cache.py
# ---------------------------------------------------------------------------

def test_put_fetch_roundtrip():
    c = ClockCache(4)
    c.put("a", 1)
    assert c.fetch("a") == 1
    assert c.request("a") is True
    assert c.request("zzz") is False


def test_capacity_eviction():
    c = ClockCache(3)
    for i in range(10):
        c.put(i, i * 10)
    assert len(c) == 3
    assert c.evictions == 7


def test_clock_second_chance():
    """Referenced entries survive one sweep; unreferenced are evicted first."""
    c = ClockCache(3)
    c.put("a", 1)
    c.put("b", 2)
    c.put("c", 3)
    c._ref[:] = False                 # clear all ref bits with one sweep
    c.fetch("a")                      # re-reference only 'a'
    c.put("d", 4)                     # must evict b or c, not a
    assert "a" in c and "d" in c
    assert ("b" in c) + ("c" in c) == 1


def test_update_in_place_no_eviction():
    c = ClockCache(2)
    c.put("a", 1)
    c.put("a", 2)
    c.put("b", 3)
    assert c.fetch("a") == 2 and c.evictions == 0


def test_prediction_cache_model_scoped():
    pc = PredictionCache(8)
    x = np.arange(4, dtype=np.float32)
    pc.put("m1", x, "y1")
    assert pc.fetch("m1", x) == "y1"
    assert pc.fetch("m2", x) is None          # per-model keys (paper §4.2)


def test_digest_array_content():
    a = np.arange(4, dtype=np.float32)
    b = np.arange(4, dtype=np.float32)
    c = a.reshape(2, 2)
    assert digest(a) == digest(b)
    assert digest(a) != digest(c)


def test_digest_scalar_types_do_not_collide():
    keys = {digest(1), digest(1.0), digest(True)}
    assert len(keys) == 3
    assert digest("1") not in keys
    assert digest(0) != digest(False)


def test_digest_container_types_do_not_collide():
    assert digest([1, 2]) != digest((1, 2))
    assert digest([1, 2]) == digest([1, 2])
    assert digest((1,)) != digest((1.0,))


def test_clock_eviction_when_every_ref_bit_set():
    c = ClockCache(3)
    for k in ("a", "b", "c"):
        c.put(k, k)
    assert c._hand == 0                       # wrapped during the fill
    for k in ("a", "b", "c"):
        assert c.request(k) is True           # every ref bit set
    c.put("d", 4)
    assert "a" not in c and "d" in c
    assert "b" in c and "c" in c
    assert c.evictions == 1
    assert c._hand == 1                       # advanced past the victim
    assert not c._ref.any()                   # one full lap cleared all bits


def test_clock_reinsert_evicted_key_counters_and_hand():
    c = ClockCache(3)
    for k in ("a", "b", "c"):
        c.put(k, k)
    for k in ("a", "b", "c"):
        c.request(k)
    c.put("d", 4)                             # evicts 'a'
    hits, misses = c.hits, c.misses
    assert c.request("a") is False            # evicted: a genuine miss
    assert c.misses == misses + 1 and c.hits == hits
    c.put("a", 10)                            # re-insert the evicted key
    assert c.fetch("a") == 10
    assert "b" not in c and "c" in c and "d" in c
    assert c.evictions == 2
    assert c._hand == 2
    assert c.request("a") is True             # present again: a hit
    assert c.hits == hits + 1


@given(st.lists(st.tuples(st.integers(0, 30), st.integers(0, 100)),
                min_size=1, max_size=200),
       st.integers(1, 8))
@settings(max_examples=50, deadline=None)
def test_cache_invariants(ops, capacity):
    c = ClockCache(capacity)
    for key, val in ops:
        c.put(key, val)
        assert c.fetch(key) == val
        assert len(c) <= capacity
    assert c.hits + c.misses >= 0


@given(st.integers(2, 6))
@settings(max_examples=20, deadline=None)
def test_cache_hot_key_survives(capacity):
    c = ClockCache(capacity + 1)
    c.put("hot", 0)
    for i in range(50):
        assert c.request("hot") is True
        c.put(("cold", i), i)
    assert "hot" in c


# ---------------------------------------------------------------------------
# port-side copies of tests/test_frontend.py
# ---------------------------------------------------------------------------

def _models(rng):
    def good(x):
        return np.eye(3)[np.abs(x).sum(1).astype(int) % 3]

    def bad(x):
        return rng.normal(size=(len(x), 3))

    return {"good": good, "bad": bad}


def _trace(rng, n, gap=0.002):
    return [(i * gap, rng.normal(size=(4,)).astype(np.float32), 0)
            for i in range(n)]


def test_slo_bounded_latency_under_stragglers():
    rng = np.random.default_rng(0)
    clip = make_clipper(
        _models(rng), "exp4", slo=0.02, device=CPU,
        latency_models={"good": linear_latency(0.001, 1e-4),
                        "bad": linear_latency(0.002, 2e-4, p_straggle=0.05,
                                              straggle_factor=30)})
    qids = clip.replay(_trace(rng, 300))
    lat = np.array([clip.results[q].latency for q in qids])
    assert len(clip.results) == 300
    assert np.percentile(lat, 99) <= 0.02 + 1e-9
    assert any(clip.results[q].missing_models for q in qids)


def test_every_query_gets_prediction_and_confidence():
    rng = np.random.default_rng(1)
    clip = make_clipper(_models(rng), "exp4", slo=0.05, device=CPU,
                        latency_models={"good": linear_latency(0.001, 1e-4),
                                        "bad": linear_latency(0.001, 1e-4)})
    qids = clip.replay(_trace(rng, 50))
    for q in qids:
        p = clip.results[q]
        assert p.y is not None and 0.0 <= p.confidence <= 1.0


def test_feedback_downweights_bad_model():
    rng = np.random.default_rng(2)
    clip = make_clipper(_models(rng), "exp4", slo=0.05, device=CPU,
                        latency_models={"good": linear_latency(0.001, 1e-4),
                                        "bad": linear_latency(0.001, 1e-4)})
    xs = [rng.normal(size=(4,)).astype(np.float32) for _ in range(150)]
    qids = clip.replay([(i * 0.002, x, 0) for i, x in enumerate(xs)])
    for q, x in zip(qids, xs):
        clip.feedback(Feedback(q, x, int(np.abs(x).sum()) % 3))
    w = exp4_weights(clip.policy_state).numpy()
    ids = sorted(_models(rng))                 # ['bad', 'good']
    assert w[ids.index("good")] > 0.9


def test_feedback_join_uses_cache():
    rng = np.random.default_rng(3)
    clip = make_clipper(_models(rng), "exp4", slo=0.05, device=CPU,
                        latency_models={"good": linear_latency(0.001, 1e-4),
                                        "bad": linear_latency(0.001, 1e-4)})
    xs = [rng.normal(size=(4,)).astype(np.float32) for _ in range(30)]
    qids = clip.replay([(i * 0.002, x, 0) for i, x in enumerate(xs)])
    for q, x in zip(qids, xs):
        clip.feedback(Feedback(q, x, 0))
    assert clip.feedback_cache_hit_rate == 1.0   # §4.2: join hits the cache


def test_cache_serves_repeated_queries_fast():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4,)).astype(np.float32)
    clip = make_clipper(_models(rng), "exp4", slo=0.05, device=CPU,
                        latency_models={"good": linear_latency(0.005, 1e-4),
                                        "bad": linear_latency(0.005, 1e-4)})
    qids = clip.replay([(i * 0.001, x, 0) for i in range(20)])
    lat = [clip.results[q].latency for q in qids]
    assert min(lat[5:]) < 1e-6


def test_exp3_single_model_per_query():
    rng = np.random.default_rng(5)
    clip = make_clipper(_models(rng), "exp3", slo=0.05, device=CPU,
                        latency_models={"good": linear_latency(0.001, 1e-4),
                                        "bad": linear_latency(0.001, 1e-4)})
    qids = clip.replay(_trace(rng, 40))
    for q in qids:
        assert len(clip.results[q].model_ids) == 1


def test_contextual_frontend_feedback_matches_reference():
    """The frontend with a contextual store (``Clipper._observe_contextual``)
    in both packages: per-user Exp4 and Exp3 feedback over the same replay
    leave the same store within 1e-6, and the same predictions."""
    from repro.core.frontend import make_clipper as jmake
    for kind in ("exp4", "exp3"):
        outs = []
        for make, store in ((jmake, jcontext.ContextualStore(3, 2, kind=kind)),
                            (make_clipper, ContextualStore(3, 2, kind=kind,
                                                           device=CPU))):
            rng = np.random.default_rng(8)
            kw = {} if make is jmake else {"device": CPU}
            clip = make(_models(rng), kind, slo=0.05, contextual_store=store,
                        latency_models={"good": linear_latency(0.001, 1e-4),
                                        "bad": linear_latency(0.001, 1e-4)},
                        **kw)
            xs = [rng.normal(size=(4,)).astype(np.float32)
                  for _ in range(60)]
            qids = clip.replay([(i * 0.002, x, i % 3)
                                for i, x in enumerate(xs)])
            for q, x in zip(qids, xs):
                clip.feedback(Feedback(q, x, int(np.abs(x).sum()) % 3,
                                       context_id=q % 3))
            outs.append((_np(store.states),
                         [clip.results[q].model_ids for q in qids]))
        np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0, atol=ATOL)
        assert outs[1][1] == outs[0][1]


# ---------------------------------------------------------------------------
# port-side copies of the frontend cases of tests/test_workloads.py
# ---------------------------------------------------------------------------

def test_frontend_poisson_report_byte_identical():
    a = ScenarioRunner(Scenario("t", rate=300.0, duration=1.0),
                       device=CPU).run("frontend")
    b = ScenarioRunner(Scenario("t", rate=300.0, duration=1.0),
                       device=CPU).run("frontend")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_frontend_poisson_exact_oracles():
    rep = ScenarioRunner(Scenario("t", rate=300.0, duration=1.0, seed=5),
                         device=CPU).run("frontend")
    assert rep["schema"] == "repro.metrics/v1"
    assert rep["queries"]["completed"] == rep["queries"]["submitted"] > 0
    assert rep["latency_s"]["p99"] <= rep["slo"]["target_s"]
    assert rep["slo"]["violations"] == 0
    assert rep["slo"]["rate"] == 0.0
    assert rep["cache"]["hit_rate"] > 0.3
    assert rep["throughput_qps"] > 0


def test_frontend_bursty_exact_oracles():
    sc = Scenario("t", kind="bursty", rate=100.0, peak_rate=2000.0,
                  duration=1.0, seed=2)
    rep1 = ScenarioRunner(sc, device=CPU).run("frontend")
    rep2 = ScenarioRunner(sc, device=CPU).run("frontend")
    assert rep1 == rep2                           # exact, not approximate
    assert rep1["queries"]["completed"] == rep1["queries"]["submitted"]
    assert rep1["batch_size"]["max"] > 1
    assert rep1["latency_s"]["p99"] <= sc.slo


def test_frontend_straggler_scenario_accounting():
    rep = run_scenario("stragglers", duration=1.0, device=CPU)
    assert rep["stragglers"]["partial_queries"] > 0
    assert (rep["stragglers"]["dropped_models"]
            >= rep["stragglers"]["partial_queries"])
    assert rep["latency_s"]["p99"] <= rep["slo"]["target_s"] * 10 ** (0.5 / 24)
    assert rep["latency_s"]["max"] <= rep["slo"]["target_s"] + 1e-9
    assert rep["slo"]["violations"] == 0


def test_frontend_scaling_scenario_replicas():
    rep = run_scenario("scaling", duration=0.5, device=CPU)
    assert rep["scenario"]["replicas"] == 4
    assert rep["queries"]["completed"] == rep["queries"]["submitted"]


def test_report_p99_matches_reference_histogram():
    def fn(x):
        return np.zeros((len(x), 10), np.float32)

    clip = make_clipper({"m": fn}, "exp4", slo=0.02, device=CPU,
                        latency_models={"m": linear_latency(0.001, 1e-5)})
    trace = query_trace(poisson_trace(400.0, 0.5, seed=9), seed=9, pool=0)
    qids = clip.replay(trace)
    ref = StreamingHistogram(1e-6, 1e4, 24)
    for q in qids:
        ref.observe(clip.results[q].latency)
    rep = clip.report()
    assert rep["latency_s"]["p99"] == ref.percentile(99)
    assert rep["latency_s"]["p50"] == ref.percentile(50)


# ---------------------------------------------------------------------------
# port-side copies of the tracer cases of tests/test_obs.py (those that need
# neither metrics.validate nor pipeline: later slices of the port)
# ---------------------------------------------------------------------------

_FE = dict(rate=200.0, duration=0.2, seed=11)
_LM = dict(duration=0.05, rate=200.0, lm_requests=5, slots=2,
           prompt_len=4, max_new_tokens=2, seed=11)


def _run_traced(stack, **kw):
    sc = Scenario("t", **kw)
    tr = Tracer(sample_rate=1.0, seed=sc.seed)
    rep = ScenarioRunner(sc, tracer=tr, device=CPU).run(stack)
    return rep, tr


def test_sampling_deterministic_and_calibrated():
    ids = range(1, 4001)
    picks = {t for t in ids if sample_decision(7, t, 0.3)}
    assert picks == {t for t in ids if sample_decision(7, t, 0.3)}
    assert 0.2 < len(picks) / 4000 < 0.4
    assert picks != {t for t in ids if sample_decision(8, t, 0.3)}
    assert all(sample_decision(7, t, 1.0) for t in ids)
    assert not any(sample_decision(7, t, 0.0) for t in ids)


def test_unsampled_traces_consume_ids_and_propagate_none():
    tr = Tracer(sample_rate=0.0, seed=0)
    root = tr.start_trace("query", "frontend", 0.0)
    assert root is None
    assert tr.start_span(root, "queue", "frontend.queue", 0.0) is None
    tr.end_span(None, 1.0)
    tr.event(root, "hit", "frontend.cache", 0.5)
    tr.end_trace(root, 1.0, attribution={"frontend.queue": 1.0})
    assert tr.traces == 1 and tr.sampled == 0
    assert len(tr.spans()) == 0
    assert tr.attribution_report()["queries"] == 0


def test_sampled_subset_identical_across_runs():
    def subset():
        tr = Tracer(sample_rate=0.5, seed=3)
        kept = []
        for i in range(200):
            root = tr.start_trace("query", "frontend", float(i))
            if root is not None:
                kept.append(root.trace_id)
                tr.end_trace(root, i + 1.0)
        return kept
    a, b = subset(), subset()
    assert a == b
    assert 0 < len(a) < 200


def test_spanlog_ring_bounds_memory_and_counts_dropped():
    log = SpanLog(capacity=8)
    for i in range(20):
        log.append(Span(i, 1, None, f"s{i}", "c", float(i), end=float(i)))
    assert len(log) == 8
    assert log.total == 20
    assert log.dropped == 12
    assert [s.name for s in log.spans()] == [f"s{i}" for i in range(12, 20)]


def test_tracer_reports_drops_in_summary_and_document():
    tr = Tracer(sample_rate=1.0, seed=0, capacity=4)
    for i in range(10):
        root = tr.start_trace("query", "frontend", float(i))
        tr.end_trace(root, i + 0.5)
    doc = tr.to_dict()
    assert doc["dropped"] == 6 and len(doc["spans"]) == 4
    assert doc["spans_total"] == 10


@pytest.mark.parametrize("stack,kw", [("frontend", _FE), ("lmserver", _LM)])
def test_trace_byte_identical_per_seed(stack, kw):
    _, t1 = _run_traced(stack, **kw)
    _, t2 = _run_traced(stack, **kw)
    assert t1.to_json() == t2.to_json()
    assert len(t1.spans()) > 0


def _roots(tr, name):
    return [s for s in tr.spans()
            if s.parent_id is None and s.kind == "span" and s.name == name]


@pytest.mark.parametrize("stack,root,kw", [
    ("frontend", "query", _FE),
    ("lmserver", "request", _LM),
])
def test_per_query_attribution_partitions_latency(stack, root, kw):
    rep, tr = _run_traced(stack, **kw)
    roots = _roots(tr, root)
    attributed = [r for r in roots if (r.attrs or {}).get("attribution")]
    assert attributed, "expected at least one attributed query"
    for r in attributed:
        total = sum(r.attrs["attribution"].values())
        assert total == pytest.approx(r.end - r.start, abs=1e-9)
    att = rep["latency_attribution"]
    assert att["queries"] == len(attributed)
    fracs = [c["fraction"] for c in att["components"].values()]
    assert sum(fracs) == pytest.approx(1.0, abs=1e-6)
    assert all(f >= 0 for f in fracs)


def test_child_spans_nest_within_parent_bounds():
    for _, tr in (_run_traced("frontend", **_FE),
                  _run_traced("lmserver", **_LM)):
        doc = tr.to_dict()
        by_id = {s["span_id"]: s for s in doc["spans"]}
        checked = 0
        for s in doc["spans"]:
            p = by_id.get(s["parent_id"])
            if p is None:
                continue
            assert s["start"] >= p["start"] - 1e-9
            assert s["end"] <= p["end"] + 1e-9
            checked += 1
        assert checked > 0


def test_budget_annotations_present_on_roots():
    _, tr = _run_traced("frontend", **_FE)
    assert all(r.budget_s is not None for r in _roots(tr, "query"))


def test_tracing_off_by_default_adds_no_report_sections():
    rep = ScenarioRunner(Scenario("t", **_FE), device=CPU).run("frontend")
    assert "latency_attribution" not in rep
    assert "trace" not in rep


def test_lm_report_always_carries_engine_section():
    rep = ScenarioRunner(Scenario("t", **_LM), device=CPU).run("lmserver")
    eng = rep["engine"]
    assert set(eng) == {"fused", "attention_backend", "prefill", "decode"}
    assert eng["prefill"]["dispatches"] >= 1
    assert eng["prefill"]["compiled_shapes"] == len(eng["prefill"]["shapes"])
    assert eng["decode"]["steps"] >= 1
    assert eng["decode"]["host_syncs_per_step"] is not None
    assert eng["decode"]["graph"] is False             # no CUDA graph here


def test_policy_state_copies_one_per_query(monkeypatch):
    """The frontend reads the Exp4 state once per query it renders from
    more than one model (``Exp4Policy.combine``): the copies
    ``chip_smoke.py`` counts on the card."""
    from repro_torch.workloads import scenario
    made = []
    real = scenario.make_clipper

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(scenario, "make_clipper", spy)
    rep = ScenarioRunner(dataclasses.replace(SCENARIOS["stragglers"],
                                             duration=0.3),
                         device=CPU).run("frontend")
    clip, = made
    multi = sum(len(p.model_ids) > 1 for p in clip.results.values())
    assert clip.policy.host_copies == multi > 0
    assert rep["queries"]["completed"] == len(clip.results)
