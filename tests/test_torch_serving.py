"""Serving slice parity: the port's LMServer against the JAX LMServer.

Same bridged weights, same prompts, calibrated-simulation mode
(VirtualClock + service model, temperature 0): the greedy token streams
must be identical, the ``repro.metrics/v1`` report byte-identical, and each
decode step must make exactly one device-to-host copy."""

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
    import jax
    from repro.serving import engine as jax_engine
    from repro_torch.serving import engine as torch_engine

    jm, jp, tm, tp = build_pair(name)
    rng = np.random.default_rng(seed)
    vocab = tm.cfg.vocab_size
    # mixed prompt lengths: several ladder rungs, ragged kv_valid
    prompts = [rng.integers(0, vocab, size=int(n))
               for n in rng.integers(3, 40, size=9)]
    jsrv, tsrv = _servers(jm, tm, slots=4, max_len=MAX_LEN, temperature=0.0)
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
    implementation that ran (``"jnp"`` there, ``"plain"`` here)."""
    sc = SCENARIOS["poisson"]
    runner = ScenarioRunner(sc)
    jsrv, jclock, jparams, pending = runner.build_lmserver()
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
                    service_model=service_model, model_id=cfg.name)
    _drive(jsrv, jclock, jparams, pending, sc.max_new_tokens)
    _drive(tsrv, tclock, tp, pending, sc.max_new_tokens)
    assert_reports_match(jsrv, tsrv)


def assert_reports_match(jsrv, tsrv):
    """Same stats, the same report byte for byte but the backend name
    (``"jnp"`` there, ``"plain"`` here), the same tokens per request."""
    assert jsrv.stats == tsrv.stats
    jrep = jsrv.report()
    assert jrep["engine"]["attention_backend"] == "jnp"
    assert tsrv.report()["engine"]["attention_backend"] == "plain"
    jrep["engine"]["attention_backend"] = "plain"
    assert (json.dumps(jrep, sort_keys=True, indent=2)
            == tsrv.report_json())
    for rid, r in jsrv.completed.items():
        assert tsrv.completed[rid].tokens == r.tokens


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
