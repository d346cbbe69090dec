"""Serving slice parity: the port's LMServer against the JAX LMServer.

Same bridged weights, same prompts, calibrated-simulation mode
(VirtualClock + service model, temperature 0): the greedy token streams
must be identical, the ``repro.metrics/v1`` report byte-identical, and each
fused decode step must make exactly one device-to-host copy; the same for
the reference per-slot loop (``fused=False``), whose steps make one copy
plus one per active slot. In wall-clock mode the prefill's service time
ends before the first token is sampled, in both engines."""

import json

import numpy as np
import pytest
import torch

from _torch_parity import build_pair, mesh_rules

from repro.core.metrics import VirtualClock
from repro.serving.engine import LMServer as JLMServer
from repro.workloads.scenario import SCENARIOS, ScenarioRunner
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import ARCHITECTURES as T_ARCHITECTURES
from repro_torch.configs.registry import reduced_config as t_reduced_config
from repro_torch.core.metrics import VirtualClock as TVirtualClock
from repro_torch.models.api import build_model
from repro_torch.serving.engine import LMServer
from repro_torch.serving.sampler import sample

MAX_LEN = 48


def _service_model(kind, batch, tokens):
    return (0.004 + 5e-5 * batch * tokens if kind == "prefill"
            else 0.001 + 5e-5 * batch)


def _servers(jm, tm, **kw):
    mesh, rules = mesh_rules()
    jsrv = JLMServer(jm, mesh, rules, clock=VirtualClock(),
                     service_model=_service_model, **kw)
    tsrv = LMServer(tm, device="cpu", clock=TVirtualClock(),
                    service_model=_service_model, **kw)
    return jsrv, tsrv


def _bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 2.0 ** -133


def _record_logits(monkeypatch, srv, engine_module, to_numpy, sync):
    """Record, per request, the logits row each of its tokens was sampled
    from: wraps the engine module's ``sample`` and the server's ``_admit``
    and ``_decode_once``. A prefill's row i belongs to the i-th admitted
    slot in slot order, a decode step's row s to the request in slot s."""
    calls, per_req = [], {}
    sample = engine_module.sample

    def recording_sample(logits, key, **kw):
        to_numpy(logits, calls)
        return sample(logits, key, **kw)

    monkeypatch.setattr(engine_module, "sample", recording_sample)
    admit, decode = srv._admit, srv._decode_once

    def recording_admit(params):
        before, n = set(srv._active), len(calls)
        admit(params)
        sync()
        if len(calls) > n:
            new = sorted(s for s in srv._active if s not in before)
            for i, s in enumerate(new):
                per_req.setdefault(srv._active[s].request_id, []).append(
                    calls[-1][i])

    def recording_decode(params):
        slots = {s: r.request_id for s, r in srv._active.items()}
        n = len(calls)
        decode(params)
        sync()
        if len(calls) > n:
            for s, rid in slots.items():
                per_req[rid].append(calls[-1][s])

    monkeypatch.setattr(srv, "_admit", recording_admit)
    monkeypatch.setattr(srv, "_decode_once", recording_decode)
    return per_req


@pytest.mark.parametrize("seed", [11, 12, 17])
@pytest.mark.parametrize("name", ["g2", "g3", "x8"])
def test_greedy_streams_identical(monkeypatch, name, seed):
    """Each request's greedy stream is JAX's, token for token, up to the
    first step whose two best JAX logits lie within one bf16 ulp: there a
    one-ulp difference from the libraries' fp32 summation orders may pick
    the other token (ROADMAP.md §C). A divergence anywhere else fails."""
    assert_greedy_streams_match(monkeypatch, name, seed, fused=True)


@pytest.mark.parametrize("seed", [11, 12, 17])
@pytest.mark.parametrize("name", ["g2", "g3", "x8"])
def test_reference_loop_greedy_streams_identical(monkeypatch, name, seed):
    """``fused=False``, the reference's per-slot loop, in both engines: the
    same streams under the same one-ulp tie rule, the same stats (host syncs
    included), and per decode step one host copy plus one per active
    slot."""
    jsrv, tsrv = assert_greedy_streams_match(monkeypatch, name, seed,
                                             fused=False)
    assert tsrv.engine_report()["fused"] is False
    assert tsrv.stats == jsrv.stats
    assert tsrv.decode_host_syncs == tsrv.decode_steps + sum(
        len(r.tokens) - 1 for r in tsrv.completed.values())


def assert_greedy_streams_match(monkeypatch, name, seed, *, fused):
    import jax
    from repro.serving import engine as jax_engine
    from repro_torch.serving import engine as torch_engine

    jm, jp, tm, tp = build_pair(name)
    rng = np.random.default_rng(seed)
    vocab = tm.cfg.vocab_size
    # mixed prompt lengths: several ladder rungs, ragged kv_valid
    lengths = rng.integers(3, 40, size=9)
    if not fused and name == "x8":
        # the reference loop prefills prompts unpadded, and both engines'
        # chunked scan takes only whole chunks of 8 there
        lengths = -(-lengths // 8) * 8
    prompts = [rng.integers(0, vocab, size=int(n)) for n in lengths]
    jsrv, tsrv = _servers(jm, tm, slots=4, max_len=MAX_LEN, temperature=0.0,
                          fused=fused)
    logits = [
        _record_logits(
            monkeypatch, jsrv, jax_engine,
            lambda x, out: jax.debug.callback(
                lambda a: out.append(np.asarray(a).astype(np.float32)), x),
            jax.effects_barrier),
        _record_logits(
            monkeypatch, tsrv, torch_engine,
            lambda x, out: out.append(x.float().numpy().copy()),
            lambda: None)]
    streams = []
    for srv, params in ((jsrv, jp), (tsrv, tp)):
        rids = [srv.submit(p, max_new_tokens=8) for p in prompts]
        srv.run(params)
        streams.append({r: srv.completed[r].tokens for r in rids})
    for rid in rids:
        jt, tt = streams[0][rid], streams[1][rid]
        assert len(jt) == len(tt) == 8
        assert [int(np.argmax(row)) for row in logits[0][rid]] == jt
        assert [int(np.argmax(row)) for row in logits[1][rid]] == tt
        k = next((i for i, (a, b) in enumerate(zip(jt, tt)) if a != b), None)
        if k is None:
            continue
        row = logits[0][rid][k]
        a, b = jt[k], tt[k]
        gap = float(row[a] - row[b])
        assert gap <= _bf16_ulp(max(abs(row[a]), abs(row[b]))), (
            f"request {rid} diverges at token {k}: JAX picks {a} "
            f"(logit {row[a]}), the port {b} (JAX logit {row[b]}): not a "
            f"bf16 near-tie")
    assert tsrv.rung_dispatches == jsrv.rung_dispatches
    assert len(tsrv.rung_dispatches) > 1
    return jsrv, tsrv


def _drive(srv, clock, params, pending, max_new_tokens):
    """The arrival loop of ``ScenarioRunner.run_lmserver``."""
    i = 0
    while i < len(pending) or srv.pending:
        while i < len(pending) and pending[i][0] <= clock.now:
            at, prompt = pending[i]
            srv.submit(prompt, max_new_tokens=max_new_tokens, now=at)
            i += 1
        if not srv.pending and i < len(pending):
            clock.advance(pending[i][0] - clock.now)
            continue
        srv.step(params)


def test_calibrated_report_byte_identical():
    """The poisson lmserver scenario as ``workloads/scenario.py`` builds it
    (reduced smollm, VirtualClock, service model, temperature 0), run by
    both engines on the same weights and arrivals. The reports agree byte
    for byte except ``engine.attention_backend``, which names the
    implementation that ran (``"jnp"`` there, ``"plain"`` here), and the
    port's ``engine.decode.graph`` (no CUDA graph on the CPU)."""
    assert_scenario_reports_match(fused=True)


def test_reference_loop_calibrated_report_byte_identical():
    """The same scenario through ``fused=False`` in both engines: the
    reports (``"fused": false``, one host sync per step plus one per active
    slot, same-length prefill groups) agree byte for byte but the two
    fields above."""
    jrep = assert_scenario_reports_match(fused=False)
    assert jrep["engine"]["fused"] is False
    assert jrep["engine"]["decode"]["host_syncs_per_step"] > 1.0


def assert_scenario_reports_match(*, fused):
    sc = SCENARIOS["poisson"]
    runner = ScenarioRunner(sc)
    jsrv, jclock, jparams, pending = runner.build_lmserver()
    if not fused:
        jsrv = JLMServer(jsrv.model, jsrv.mesh, jsrv.rules, slots=sc.slots,
                         max_len=64, slo=sc.slo, temperature=0.0,
                         seed=sc.seed, clock=jclock,
                         service_model=jsrv.service_model,
                         model_id=jsrv.model_id, fused=False)
    cfg = t_reduced_config(T_ARCHITECTURES["smollm-360m"], num_layers=2,
                           d_model=64)
    tm = build_model(cfg, device="cpu")
    import jax
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tclock = TVirtualClock()

    def service_model(kind: str, batch: int, tokens: int) -> float:
        if kind == "prefill":
            return sc.base_latency + sc.per_item_latency * batch * tokens
        return sc.base_latency / 4 + sc.per_item_latency * batch

    tsrv = LMServer(tm, device="cpu", slots=sc.slots, max_len=64,
                    slo=sc.slo, temperature=0.0, seed=sc.seed, clock=tclock,
                    service_model=service_model, model_id=cfg.name,
                    fused=fused)
    _drive(jsrv, jclock, jparams, pending, sc.max_new_tokens)
    _drive(tsrv, tclock, tp, pending, sc.max_new_tokens)
    return assert_reports_match(jsrv, tsrv)


def assert_reports_match(jsrv, tsrv):
    """Same stats, the same report byte for byte but the backend name
    (``"jnp"`` there, ``"plain"`` here) and the port's graph flag (false on
    the CPU), the same tokens per request. Returns the JAX report."""
    assert jsrv.stats == tsrv.stats
    jrep = jsrv.report()
    trep = tsrv.report()
    assert jrep["engine"]["attention_backend"] == "jnp"
    assert trep["engine"]["attention_backend"] == "plain"
    assert trep["engine"]["decode"].pop("graph") is False
    jrep["engine"]["attention_backend"] = "plain"
    assert (json.dumps(jrep, sort_keys=True, indent=2)
            == json.dumps(trep, sort_keys=True, indent=2))
    for rid, r in jsrv.completed.items():
        assert tsrv.completed[rid].tokens == r.tokens
    return jrep


def test_prefill_service_time_excludes_the_first_token_sample(monkeypatch):
    """Wall-clock mode (no service model) with a clock that moves only
    while a prefill's first token is sampled, by more than the prefill's
    AIMD budget: the JAX engine ends the prefill's service time before it
    samples, so the sample is charged to no prefill. The port must agree:
    the same ``prefill_time`` per request (0), the same AIMD state, the
    same queue and prefill spans, the same streams."""
    from repro.obs.tracer import Tracer
    from repro.serving import engine as jax_engine
    from repro_torch.serving import engine as torch_engine

    jm, jp, tm, tp = build_pair("g3")
    mesh, rules = mesh_rules()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tm.cfg.vocab_size, size=int(n))
               for n in rng.integers(3, 40, size=9)]
    runs = []
    for module, make, params in (
            (jax_engine, lambda **kw: JLMServer(jm, mesh, rules, **kw), jp),
            (torch_engine, lambda **kw: LMServer(tm, device="cpu", **kw),
             tp)):
        clock, tracer = TVirtualClock(), Tracer()
        srv = make(slots=4, max_len=MAX_LEN, slo=0.5, temperature=0.0,
                   clock=clock, tracer=tracer)
        admitting = []
        sample_fn = module.sample

        def slow_sample(logits, key, _sample=sample_fn, _clock=clock,
                        _admitting=admitting, **kw):
            if _admitting:
                _clock.advance(0.3)        # > slo * prefill_slo_frac
            return _sample(logits, key, **kw)

        def admit(params, _admit=srv._admit, _admitting=admitting):
            _admitting.append(True)
            try:
                _admit(params)
            finally:
                _admitting.clear()

        monkeypatch.setattr(module, "sample", slow_sample)
        monkeypatch.setattr(srv, "_admit", admit)
        rids = [srv.submit(p, max_new_tokens=6) for p in prompts]
        srv.run(params)
        spans = [sp.to_dict() for sp in tracer.spans()
                 if sp.name in ("queue", "prefill")]
        runs.append(dict(
            prefill_time=[srv.completed[r].prefill_time for r in rids],
            aimd=(srv.admission._max, srv.admission.max_batch_size),
            spans=spans, stats=srv.stats,
            tokens=[srv.completed[r].tokens for r in rids]))
    jrun, trun = runs
    assert jrun["prefill_time"] == [0.0] * len(prompts)
    assert trun["prefill_time"] == jrun["prefill_time"]
    assert trun["aimd"] == jrun["aimd"]
    assert len(jrun["spans"]) == 2 * len(prompts)
    assert trun["spans"] == jrun["spans"]
    assert trun["stats"] == jrun["stats"]
    assert trun["tokens"] == jrun["tokens"]


_SYNCING = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
            "__float__", "__index__")


def test_one_host_copy_per_decode_step(monkeypatch):
    """A decode step calls no tensor-to-host method but the one ``.cpu()``
    of the packed ``[tokens ‖ done]`` (and ``.numpy()`` on that host copy)."""
    _, _, tm, tp = build_pair("g3")
    assert_one_host_copy_per_step(monkeypatch, tm, tp)


def assert_one_host_copy_per_step(monkeypatch, tm, tp):
    srv = LMServer(tm, device="cpu", slots=4, max_len=MAX_LEN,
                   clock=TVirtualClock(), service_model=_service_model)
    rng = np.random.default_rng(5)
    for n in (5, 9, 17):
        srv.submit(rng.integers(0, tm.cfg.vocab_size, size=n),
                   max_new_tokens=6)
    srv._admit(tp)
    calls = {name: 0 for name in _SYNCING}
    for name in _SYNCING:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    steps = 4
    for _ in range(steps):
        srv._decode_once(tp)
    monkeypatch.undo()
    assert calls == dict({n: 0 for n in _SYNCING}, cpu=steps, numpy=steps)
    assert srv.stats["host_syncs_per_decode_step"] == 1.0


def test_entry_points_run_on_the_card_or_raise(monkeypatch):
    cfg = t_reduced_config(T_ARCHITECTURES["smollm-360m"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        LMServer(model)
    with pytest.raises(ValueError):
        LMServer(model, device="meta")


def test_temperature_sampling_distribution():
    """Temperature > 0 draws from softmax(logits / T) (the JAX engine draws
    from jax.random, which torch cannot reproduce: only the distribution is
    compared). 40k draws: frequencies within 0.01 of the probabilities."""
    logits = torch.tensor([[1.0, 2.0, 0.5, -1.0]]).repeat(40_000, 1)
    gen = torch.Generator().manual_seed(0)
    toks = sample(logits, gen, temperature=0.7)
    freq = np.bincount(toks.numpy(), minlength=4) / len(toks)
    probs = torch.softmax(logits[0] / 0.7, -1).numpy()
    np.testing.assert_allclose(freq, probs, atol=0.01)
    top2 = sample(logits, gen, temperature=0.7, top_k=2)
    assert set(np.unique(top2.numpy())) <= {0, 1}
    assert torch.equal(sample(logits[:3], temperature=0.0),
                       torch.tensor([1, 1, 1], dtype=torch.int32))
