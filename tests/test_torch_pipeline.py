"""Prediction pipelines (DESIGN.md §12) on the port: the pipelines'
documents held against the reference's, then the port-side copy of
``tests/test_pipeline.py`` (graph spec validation, the deadline splitter's
InferLine properties, DAG/cascade execution on the Clipper frontend, the
intermediate-result cache, per-stage control-plane integration, and the LM
draft-then-verify cascade — exact oracles under the virtual clock), on the
CPU. Its benchmark contract drives ``benchmarks/`` and stays with the
reference.

Parity:

* the ``cascade`` and ``fanout`` pipelines, seeds 0 and 1, with and without
  the intermediate-result cache: the report and the span log equal the
  reference's byte for byte, through ``run_pipeline`` and through the CLI
  (in process and as ``python -m``);
* ``lmcascade``, the reduced LM in both tiers: on the reference's weights,
  bridged, the report equals the reference's but ``engine.attention_backend``
  and the port's ``engine.decode.graph`` and ``engine.prefill.graph`` in
  each tier's section; so do the
  span log, time series and audit doc; each request escalates or not as
  there, and each tier's token streams are the reference's up to a bf16
  near-tie (ROADMAP.md §C). At thresholds 0 (nothing escalates) and 1.5
  (everything does), where the report does not depend on the tokens, the
  same holds on the port's own weights, with the verify tier shedding (the
  degradation path) and the draft tier shedding."""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_ties import assert_streams_within_ties, record_logits

from repro.obs import AuditLog as JAuditLog
from repro.obs import BurnRateMonitor as JBurnRateMonitor
from repro.obs import FleetSampler as JFleetSampler
from repro.obs import Tracer as JTracer
from repro.pipeline import cascade as jcascade
from repro.pipeline import run as jrun
from repro.pipeline import scenario as jscenario
from repro.serving import engine as jax_engine
from repro_torch.bridge import params_from_numpy
from repro_torch.core.containers import linear_latency
from repro_torch.core.frontend import _default_loss, make_clipper
from repro_torch.obs import AuditLog, BurnRateMonitor, FleetSampler, Tracer
from repro_torch.pipeline import (CASCADE_THRESHOLD, PipelineExecutor,
                                  PipelineGraph, Stage, build_executor,
                                  cascade_graph, distinct_token_confidence,
                                  fanout_graph, make_escalate,
                                  pipeline_models, pipeline_scenario,
                                  run_lmcascade, run_pipeline, split_slo)
from repro_torch.pipeline import run as trun
from repro_torch.pipeline.scenario import build_lmcascade, drive_lmcascade
from repro_torch.serving import engine as torch_engine
from repro_torch.workloads import query_trace
from repro_torch.workloads.scenario import D_FEAT, SCENARIOS

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
LM_SC = pipeline_scenario()
# the port's tracer without the engine's step spans, which the reference's
# span log has no counterpart of
_PortTracer = functools.partial(Tracer, engine=False)


# ---------------------------------------------------------------------------
# parity: the frontend pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_cache", [True, False], ids=["cache", "no-cache"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["cascade", "fanout"])
def test_pipeline_report_and_spans_byte_identical(kind, seed, use_cache):
    sc = pipeline_scenario(seed=seed)
    docs = []
    for run, tracer, kw in ((jscenario.run_pipeline, JTracer, {}),
                            (run_pipeline, Tracer, {"device": CPU})):
        tr = tracer(sample_rate=1.0, seed=seed)
        rep = run(sc, kind, use_cache=use_cache, tracer=tr, **kw)
        docs.append((json.dumps(rep, sort_keys=True, indent=2),
                     tr.to_json()))
    assert docs[1][0] == docs[0][0]
    assert docs[1][1] == docs[0][1]
    assert len(json.loads(docs[1][1])["spans"]) > 0


@pytest.mark.parametrize("args", [
    ["--scenario", "cascade", "--no-cache", "--seed", "1"],
    ["--scenario", "fanout", "--timeseries-out", "{series}",
     "--audit-out", "{audit}"]],
    ids=["cascade-no-cache", "fanout-fleet"])
def test_pipeline_cli_writes_what_the_reference_writes(tmp_path, args):
    outs = {}
    for tag, main, dev in (("j", jrun.main, []),
                           ("t", trun.main, ["--device", CPU])):
        files = {o: tmp_path / f"{tag}.{o}.json"
                 for o in ("report", "trace", "series", "audit")}
        argv = [a.format(**files) for a in args] + [
            "--report-out", str(files["report"]),
            "--trace-out", str(files["trace"])] + dev
        assert main(argv) == 0
        outs[tag] = {o: f.read_bytes() for o, f in files.items()
                     if f.exists()}
    assert sorted(outs["t"]) == sorted(outs["j"])
    for o, data in outs["j"].items():
        assert outs["t"][o] == data, o


def test_python_m_pipeline_run_matches_reference(tmp_path):
    """The module entry points, as a user runs them: the same report."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = {}
    for tag, mod, extra in (("j", "repro.pipeline.run", []),
                            ("t", "repro_torch.pipeline.run",
                             ["--device", CPU])):
        out = tmp_path / f"{tag}.json"
        subprocess.run([sys.executable, "-m", mod, "--scenario", "fanout",
                        "--report-out", str(out)] + extra, check=True,
                       env=env, cwd=ROOT, timeout=300)
        outs[tag] = out.read_bytes()
    assert outs["t"] == outs["j"]


def test_pipeline_entry_points_run_on_the_card_or_raise(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = _sc()
    with pytest.raises(RuntimeError, match="cuda"):
        run_pipeline(sc)
    with pytest.raises(RuntimeError, match="cuda"):
        build_executor(sc)
    with pytest.raises(RuntimeError, match="cuda"):
        run_lmcascade(sc)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--scenario", "lmcascade", "--report-out",
                   str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
    with pytest.raises(SystemExit):                  # no such device
        trun.main(["--device", "meta"])
    ex = build_executor(sc, device=CPU)
    assert ex.clip.policy_state.device.type == "cpu"


# ---------------------------------------------------------------------------
# parity: the LM cascade
# ---------------------------------------------------------------------------

def _fleet(tracer, sampler, monitor, audit, sc=LM_SC):
    return dict(tracer=tracer(sample_rate=1.0, seed=sc.seed),
                sampler=sampler(interval=0.05, monitor=monitor()),
                audit=audit())


def _documents(rep, fleet):
    return (rep, fleet["tracer"].to_json(), fleet["sampler"].to_json(),
            fleet["audit"].to_json())


def _recording_cascade(mp, kept):
    """A subclass of the reference's ``LMCascade`` that keeps itself, the
    params its tiers step with, and each tier's logits rows."""

    class Recording(jcascade.LMCascade):
        def __init__(self, draft, verify, **kw):
            super().__init__(draft, verify, **kw)
            kept["cascade"] = self
            kept["logits"] = [record_logits(
                mp, srv, jax_engine,
                lambda x, out: jax.debug.callback(
                    lambda a: out.append(np.asarray(a).astype(np.float32)),
                    x),
                jax.effects_barrier) for srv in (draft, verify)]

        def step(self, draft_params, verify_params):
            kept.setdefault("params", draft_params)
            super().step(draft_params, verify_params)

    return Recording


@pytest.fixture(scope="module")
def reference():
    """The reference's lmcascade (threshold 0.9) with a tracer, a fleet
    sampler and an audit log: its documents, cascade, weights and logits."""
    kept = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcascade, "LMCascade", _recording_cascade(mp, kept))
        fleet = _fleet(JTracer, JFleetSampler, JBurnRateMonitor, JAuditLog)
        rep = jscenario.run_lmcascade(LM_SC, threshold=0.9, **fleet)
    return kept, _documents(rep, fleet)


def _tiers(rep):
    return rep["cascade"]["draft"], rep["cascade"]["verify"]


def _assert_cascade_documents_match(want, got):
    """Reports equal but the two engine fields of each tier's section; the
    other documents equal."""
    jrep, trep = json.loads(json.dumps(want[0])), got[0]
    for jt, tt in zip(_tiers(jrep), _tiers(trep)):
        assert jt["engine"]["attention_backend"] == "jnp"
        assert tt["engine"]["attention_backend"] == "plain"
        assert tt["engine"]["decode"].pop("graph") is False
        assert tt["engine"]["prefill"].pop("graph") is False
        jt["engine"]["attention_backend"] = "plain"
    assert (json.dumps(trep, sort_keys=True, indent=2)
            == json.dumps(jrep, sort_keys=True, indent=2))
    for w, g, what in zip(want[1:], got[1:], ("spans", "series", "audit")):
        assert g == w, what


def test_lmcascade_matches_reference_on_bridged_weights(reference):
    kept, want = reference
    jcasc = kept["cascade"]
    with pytest.MonkeyPatch.context() as mp:
        fleet = _fleet(_PortTracer, FleetSampler, BurnRateMonitor, AuditLog)
        casc, clock, _, pending = build_lmcascade(
            LM_SC, threshold=0.9, tracer=fleet["tracer"],
            audit=fleet["audit"], device=CPU)
        logits = [record_logits(
            mp, srv, torch_engine,
            lambda x, out: out.append(x.float().numpy().copy()),
            lambda: None) for srv in (casc.draft, casc.verify)]
        params = params_from_numpy(jax.tree.map(np.asarray, kept["params"]),
                                   device=CPU)
        rep = drive_lmcascade(LM_SC, casc, clock, params, pending,
                              sampler=fleet["sampler"])
    _assert_cascade_documents_match(want, _documents(rep, fleet))
    assert casc.escalated == jcasc.escalated
    assert 0 < casc.escalated < LM_SC.lm_requests
    assert ({c: r["tier"] for c, r in casc.results.items()}
            == {c: r["tier"] for c, r in jcasc.results.items()})
    assert len(casc.results) == LM_SC.lm_requests
    for tier, jl, tl in zip(("draft", "verify"), kept["logits"], logits):
        streams = [{rid: r.tokens for rid, r in
                    getattr(c, tier).completed.items()}
                   for c in (jcasc, casc)]
        assert sorted(streams[0]) == sorted(streams[1]), tier
        assert_streams_within_ties(streams, (jl, tl))


class _AlwaysShed:
    def admit_lm(self, srv, now):
        return False


@pytest.mark.parametrize("threshold,shed", [
    (0.0, None), (1.5, None), (1.5, "verify"), (0.9, "draft")],
    ids=["none-escalate", "all-escalate", "verify-shed", "draft-shed"])
def test_lmcascade_extremes_match_reference(threshold, shed):
    sc = _sc(lm_requests=6, max_new_tokens=4)
    kw = {f"{shed}_admission": _AlwaysShed()} if shed else {}
    want = jscenario.run_lmcascade(sc, threshold=threshold, **kw)
    got = run_lmcascade(sc, threshold=threshold, device=CPU, **kw)
    _assert_cascade_documents_match((want,), (got,))
    n = got["queries"]["submitted"]
    escalated = {0.0: 0, 1.5: n, 0.9: 0}[threshold]
    assert got["cascade"]["escalated"] == escalated
    if shed == "verify":
        assert got["admission"]["degraded"] == n
    if shed == "draft":
        assert got["admission"]["shed"] == n


# ---------------------------------------------------------------------------
# port-side copy of tests/test_pipeline.py
# ---------------------------------------------------------------------------

def _sc(**kw):
    return pipeline_scenario(**{"duration": 0.3, **kw})


# ---------------------------------------------------------------------------
# graph spec
# ---------------------------------------------------------------------------

def test_graph_validation():
    with pytest.raises(ValueError, match="unknown parent"):
        PipelineGraph([Stage("a", ("m",), parents=("ghost",))])
    with pytest.raises(ValueError, match="duplicate"):
        PipelineGraph([Stage("a", ("m",)), Stage("a", ("m",))])
    with pytest.raises(ValueError, match="cycle"):
        PipelineGraph([Stage("a", ("m",), parents=("b",)),
                       Stage("b", ("m",), parents=("a",))])
    with pytest.raises(ValueError, match="output"):
        PipelineGraph([Stage("a", ("m",)), Stage("b", ("m",))])


def test_topo_order_and_shape():
    g = cascade_graph(("cheap0", "cheap1"), "accurate",
                      preprocess_model="prep")
    assert g.order.index("prep") < g.order.index("draft")
    assert g.order.index("draft") < g.order.index("verify")
    assert g.output == "output"
    assert g.model_ids() == ["prep", "cheap0", "cheap1", "accurate"]
    d = g.describe()
    assert [s["name"] for s in d["stages"]] == g.order
    assert any(s["gated"] for s in d["stages"])


# ---------------------------------------------------------------------------
# deadline splitter: the InferLine properties (satellite)
# ---------------------------------------------------------------------------

def _chain(n):
    return PipelineGraph(
        [Stage(f"s{i}", (f"m{i}",),
               parents=((f"s{i-1}",) if i else ()))
         for i in range(n)])


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=1e-6, max_value=1.0),
                min_size=1, max_size=6),
       st.floats(min_value=1e-3, max_value=10.0))
def test_split_path_sums_to_slo(ests, slo):
    g = _chain(len(ests))
    split = split_slo(g, slo, {f"s{i}": e for i, e in enumerate(ests)})
    # a chain IS the critical path: shares sum to exactly the SLO and the
    # prefixes are the running sums, ending at the SLO
    assert sum(split.shares.values()) == pytest.approx(slo)
    assert split.prefix[g.output] == pytest.approx(slo)
    acc = 0.0
    for i in range(len(ests)):
        acc += split.shares[f"s{i}"]
        assert split.prefix[f"s{i}"] == pytest.approx(acc)
    assert all(s > 0 for s in split.shares.values())


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(min_value=1e-5, max_value=1.0),
                min_size=2, max_size=5),
       st.integers(min_value=0, max_value=4),
       st.floats(min_value=1.1, max_value=10.0))
def test_split_monotone_in_service_time(ests, idx, factor):
    idx = idx % len(ests)
    g = _chain(len(ests))
    est = {f"s{i}": e for i, e in enumerate(ests)}
    before = split_slo(g, 1.0, est)
    est[f"s{idx}"] *= factor
    after = split_slo(g, 1.0, est)
    # growing one stage's service estimate never shrinks its share, and
    # every path still fits inside the SLO
    assert after.shares[f"s{idx}"] >= before.shares[f"s{idx}"] - 1e-12
    assert sum(after.shares.values()) <= 1.0 + 1e-9


def test_split_diamond_paths_within_slo():
    g = PipelineGraph([
        Stage("a", ("m0",)),
        Stage("fast", ("m1",), parents=("a",)),
        Stage("slow", ("m2",), parents=("a",)),
        Stage("out", ("m3",), parents=("fast", "slow")),
    ])
    split = split_slo(g, 0.1, {"a": 1e-3, "fast": 1e-4, "slow": 5e-3,
                               "out": 1e-3})
    for path in (("a", "fast", "out"), ("a", "slow", "out")):
        assert sum(split.shares[s] for s in path) <= 0.1 + 1e-9
    # the critical path (through 'slow') uses the whole budget
    assert (split.shares["a"] + split.shares["slow"] + split.shares["out"]
            == pytest.approx(0.1))


# ---------------------------------------------------------------------------
# execution: cascade + fanout on the frontend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cascade_run():
    sc = _sc()
    return sc, run_pipeline(sc, "cascade", device=CPU)


def test_cascade_completes_everything(cascade_run):
    _, rep = cascade_run
    assert rep["queries"]["submitted"] > 0
    assert rep["queries"]["completed"] == rep["queries"]["submitted"]
    p = rep["pipeline"]
    # every query took exactly one gate decision on the verify stage
    assert (p["escalations"] + p["stages_skipped"]
            == rep["queries"]["submitted"])
    assert 0.0 < p["escalation_rate"] < 1.0
    assert p["stage_jobs"] > rep["queries"]["submitted"]


def test_cascade_escalates_only_low_confidence(cascade_run):
    sc, _ = cascade_run
    ex = build_executor(sc, device=CPU)
    trace = query_trace(sc.arrival_times(), sc.seed, d_feat=D_FEAT,
                        pool=sc.pool)
    pids = ex.replay(trace)
    assert set(pids) == set(ex.results)
    for pred in ex.results.values():
        y = pred.y
        assert set(y) == {"y", "confidence", "escalated"}
        if y["escalated"]:
            assert pred.confidence == 1.0      # verify answered
        else:
            assert y["confidence"] >= CASCADE_THRESHOLD
        assert y["y"].shape == (10,)


def test_cascade_report_deterministic(cascade_run):
    sc, rep = cascade_run
    again = run_pipeline(sc, "cascade", device=CPU)
    assert (json.dumps(rep, sort_keys=True)
            == json.dumps(again, sort_keys=True))


def test_fanout_graph_runs_all_branches():
    sc = _sc(pool=0)
    rep = run_pipeline(sc, "fanout", device=CPU)
    n = rep["queries"]["submitted"]
    assert rep["queries"]["completed"] == n
    # no gates in the fanout shape: every branch model sees every query
    assert rep["pipeline"]["stages_skipped"] == 0
    for mid in ("cheap0", "cheap1", "accurate"):
        pm = rep["per_model"][mid]
        assert pm["cache"]["hits"] + pm["cache"]["misses"] == n


def test_pure_combine_stage_and_default_prepare():
    # minimal DAG exercised without the scenario zoo: root model -> pure
    # combine output stage; ndarray pass-through prepare
    calls = []

    def fn(x):
        calls.append(len(x))
        return np.asarray(x, np.float32) * 2.0

    g = PipelineGraph([
        Stage("root", ("m",)),
        Stage("out", parents=("root",),
              combine=lambda xin, preds, outs: {"y": outs["root"] + 1.0}),
    ])
    ex = PipelineExecutor(g, {"m": fn}, slo=0.05, use_cache=False,
                          device=CPU)
    pid = ex.submit(np.ones(4, np.float32), arrival_time=0.0)
    ex.run()
    np.testing.assert_allclose(ex.results[pid].y["y"], np.full(4, 3.0))


# ---------------------------------------------------------------------------
# intermediate-result cache (tentpole part 3 + cache satellite)
# ---------------------------------------------------------------------------

def test_intermediate_cache_shares_prefixes_across_queries():
    sc = _sc(pool=16)                   # heavy skew: few unique queries
    rep = run_pipeline(sc, "cascade", device=CPU)
    n = rep["queries"]["submitted"]
    assert rep["cache"]["hit_rate"] > 0.5
    # per-model cache counters (satellite): exposed per stage model, and
    # consistent with the global pair
    per_model = rep["per_model"]
    for mid in ("prep", "cheap0", "cheap1", "accurate"):
        c = per_model[mid]["cache"]
        assert set(c) == {"hits", "misses", "hit_rate"}
        assert c["hits"] + c["misses"] <= n
    assert (sum(per_model[m]["cache"]["hits"] for m in per_model)
            == rep["cache"]["hits"])
    # a cached prefix skips the model: prep evaluated far fewer times than
    # queries submitted
    assert per_model["prep"]["queries"] < n


def test_cache_disabled_pays_full_price():
    sc = _sc(pool=16)
    hot = run_pipeline(sc, "cascade", device=CPU)
    cold = run_pipeline(sc, "cascade", use_cache=False, device=CPU)
    assert cold["cache"]["hits"] == 0
    cost = lambda r: sum(pm["service_s"]["sum"] or 0.0
                         for pm in r["per_model"].values())
    assert cost(cold) > cost(hot)


def test_cross_pipeline_cache_sharing():
    """Two pipelines over one executor-grade cache: the fanout pipeline's
    prep/cheap stages reuse results the cascade pipeline already computed
    (same model ids, same stage inputs -> same keys)."""
    sc = _sc(pool=8)
    models, lat, priors, _ = pipeline_models(sc)
    kw = dict(slo=sc.slo, latency_models=lat, service_priors=priors,
              seed=sc.seed, device=CPU)
    trace = query_trace(sc.arrival_times(), sc.seed, d_feat=D_FEAT,
                        pool=sc.pool)
    ex1 = PipelineExecutor(cascade_graph(("cheap0", "cheap1"), "accurate",
                                         preprocess_model="prep"),
                           models, **kw)
    ex1.replay(trace)
    # second pipeline shape, *sharing the first executor's Clipper cache*
    ex2 = PipelineExecutor(fanout_graph(("cheap0", "cheap1"),
                                        preprocess_model="prep"),
                           models, **kw)
    # share the underlying entry store (each executor keeps its own
    # telemetry registry, so ex2's hits are counted in ex2's report)
    ex2.clip.cache.cache = ex1.clip.cache.cache
    ex2.replay(trace)
    rep2 = ex2.report()
    # every prep/cheap evaluation the cascade warmed is a fanout hit
    assert rep2["per_model"]["prep"]["cache"]["hit_rate"] == 1.0


# ---------------------------------------------------------------------------
# stage deadlines feed admission; stage shares feed AIMD
# ---------------------------------------------------------------------------

def test_stage_aimd_budgets_follow_split():
    sc = _sc()
    ex = build_executor(sc, device=CPU)
    for mid, rs in ex.replica_sets.items():
        share = ex.split.shares[ex.stage_of[mid]]
        assert rs.queues[0].controller.slo == pytest.approx(share)
    # replan from live stats repoints every controller
    trace = query_trace(sc.arrival_times(), sc.seed, d_feat=D_FEAT,
                        pool=sc.pool)
    ex.replay(trace)
    assert ex.replans >= 1
    for mid, rs in ex.replica_sets.items():
        assert rs.queues[0].controller.slo == pytest.approx(
            ex.split.shares[ex.stage_of[mid]])
    # the accurate stage is the hot one: its share dominates the split
    assert (ex.split.shares[ex.stage_of["accurate"]]
            > ex.split.shares[ex.stage_of["prep"]])


def test_pipeline_admission_sheds_by_stage_deadline():
    from repro_torch.cluster import SloAdmission
    sc = _sc(rate=2000.0, pool=0, duration=0.4)       # way past saturation
    ex = build_executor(sc, admission=SloAdmission(policy="shed"),
                        device=CPU)
    trace = query_trace(sc.arrival_times(), sc.seed, d_feat=D_FEAT, pool=0)
    pids = ex.replay(trace)
    rep = ex.report()
    assert rep["admission"]["shed"] > 0
    # a pipeline query either produced an answer or was shed, never both —
    # and ``admission.shed`` is pipeline-granular (stage-level admission
    # actions are re-scoped to pipeline.stages_shed), so the completed +
    # shed partition of submitted holds like every other stack
    assert ex.shed_qids.isdisjoint(ex.results)
    assert set(pids) == ex.shed_qids | set(ex.results)
    assert rep["admission"]["shed"] == len(ex.shed_qids)
    assert (rep["queries"]["completed"] + rep["admission"]["shed"]
            == rep["queries"]["submitted"])
    assert rep["pipeline"]["stages_shed"] >= rep["admission"]["shed"]
    # stage-level shedding bounds the served tail: survivors stay sane
    assert rep["latency_s"]["p99"] < 10 * sc.slo


# ---------------------------------------------------------------------------
# control plane: per-stage provisioning + retire-during-flight (satellite)
# ---------------------------------------------------------------------------

def test_cluster_pipeline_stack_provisions_stages_independently():
    from repro_torch.cluster import ClusterPlan, run_plan
    sc = dataclasses.replace(SCENARIOS["pipeline"], duration=1.0,
                             rate=700.0, pool=0)
    rep = run_plan(ClusterPlan(scenario=sc, stack="pipeline",
                               autoscale=True, device=CPU))
    assert rep["queries"]["completed"] == rep["queries"]["submitted"]
    peaks = {a["model"]: a["peak_live"]
             for a in rep["cluster"]["autoscalers"]}
    assert set(peaks) == {"prep", "cheap0", "cheap1", "accurate"}
    # the expensive verify tier grew more than the cheap root tier
    assert peaks["accurate"] > peaks["prep"]
    again = run_plan(ClusterPlan(scenario=sc, stack="pipeline",
                                 autoscale=True, device=CPU))
    assert (json.dumps(rep, sort_keys=True)
            == json.dumps(again, sort_keys=True))


def test_retire_replica_during_pipeline_flight():
    """Retiring a stage replica while pipeline stage jobs are in flight
    must not invalidate their completion events: backlog requeues, the
    in-flight batch lands on the original (never-reused) slot index, and
    every pipeline query still completes."""
    from repro_torch.pipeline import pipeline_replica_factory
    sc = _sc(pool=0, rate=400.0)
    ex = build_executor(sc, device=CPU)
    factory = pipeline_replica_factory(sc, pipeline_models(sc)[0])
    for mid in ex.replica_sets:
        ex.replica_sets[mid].add_replica(factory(mid), now=0.0)
    trace = query_trace(sc.arrival_times(), sc.seed, d_feat=D_FEAT, pool=0)
    n_half = len(trace) // 2
    pids = []
    for at, x, _ in trace[:n_half]:
        ex.run(until=at)
        pids.append(ex.submit(x, arrival_time=at))
    # mid-flight: events pending, queues non-empty; retire replica 0 of
    # every stage model
    assert ex.pending
    for mid, rs in ex.replica_sets.items():
        rs.retire_replica(0, now=ex.now)
        assert rs.routable() == [1]
    for at, x, _ in trace[n_half:]:
        ex.run(until=at)
        pids.append(ex.submit(x, arrival_time=at))
    ex.run()
    assert not ex.pending
    assert set(pids) == set(ex.results)        # nothing lost or stuck
    rep = ex.report()
    assert rep["queries"]["completed"] == len(trace)
    for rs in ex.replica_sets.values():
        rs.reap(ex.now)      # the autoscaler tick normally does this
        assert rs.retired[0] and not rs.draining[0]


# ---------------------------------------------------------------------------
# LM cascade (draft-then-verify)
# ---------------------------------------------------------------------------

def test_distinct_token_confidence():
    assert distinct_token_confidence([]) == 0.0
    assert distinct_token_confidence([1, 2, 3, 4]) == 1.0
    assert distinct_token_confidence([7, 7, 7, 7]) == pytest.approx(0.25)
    esc = make_escalate(0.9)
    Req = type("R", (), {})
    r = Req(); r.tokens = [1, 1, 2]
    assert esc(r)
    r2 = Req(); r2.tokens = [1, 2, 3]
    assert not esc(r2)


@pytest.mark.parametrize("threshold,expect", [(0.0, 0), (1.5, None)])
def test_lmcascade_escalation_extremes(threshold, expect):
    sc = _sc(lm_requests=6, max_new_tokens=4)
    rep = run_lmcascade(sc, threshold=threshold, device=CPU)
    n = rep["queries"]["submitted"]
    assert rep["queries"]["completed"] == n
    if expect is None:
        expect = n                       # threshold > 1: everything escalates
    assert rep["cascade"]["escalated"] == expect
    assert rep["cascade"]["verify"]["queries"]["submitted"] == expect
    assert rep["cascade"]["draft"]["queries"]["submitted"] == n
    # escalated requests pay both tiers: end-to-end latency dominates the
    # draft tier's own per-request latency
    if expect == n:
        assert (rep["latency_s"]["mean"]
                > rep["cascade"]["draft"]["latency_s"]["mean"])


class _AlwaysShed:
    def admit_lm(self, srv, now):
        return False


def test_lmcascade_verify_shed_degrades_to_draft():
    """An escalated request whose verify tier sheds it keeps the draft
    answer (degraded), and a draft-tier shed is a cascade-level shed —
    requests are never silently lost."""
    sc = _sc(lm_requests=6, max_new_tokens=4)
    rep = run_lmcascade(sc, threshold=1.5,       # everything escalates...
                        verify_admission=_AlwaysShed(), device=CPU)
    n = rep["queries"]["submitted"]
    assert rep["queries"]["completed"] == n      # ...but nothing is lost
    assert rep["admission"]["degraded"] == n
    assert rep["cascade"]["verify"]["queries"]["completed"] == 0
    shed = run_lmcascade(sc, draft_admission=_AlwaysShed(), device=CPU)
    assert shed["queries"]["completed"] == 0
    assert shed["admission"]["shed"] == shed["queries"]["submitted"]


def test_lmcascade_deterministic():
    sc = _sc(lm_requests=8, max_new_tokens=8)
    a, b = run_lmcascade(sc, device=CPU), run_lmcascade(sc, device=CPU)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert 0 < a["cascade"]["escalated"] < a["queries"]["submitted"]


# ---------------------------------------------------------------------------
# satellites: _default_loss on structured predictions; CLI; bench contract
# ---------------------------------------------------------------------------

def test_default_loss_handles_structured_predictions():
    scores = np.asarray([0.1, 0.7, 0.2])
    assert _default_loss({"y": scores, "confidence": 0.5}, 1) == 0.0
    assert _default_loss({"y": scores, "confidence": 0.5}, 2) == 1.0
    assert _default_loss((scores, 0.9), 1) == 0.0
    assert _default_loss({"a": (scores, 1)}, 1) == 0.0   # nested, no 'y' key
    assert _default_loss(scores, 1) == 0.0               # plain still works
    assert _default_loss(0.25, 0.5) == pytest.approx(0.25)
    with pytest.raises(ValueError):
        _default_loss({}, 1)
    with pytest.raises(ValueError):
        _default_loss((), 1)


def test_feedback_loop_with_pipeline_style_models():
    """A frontend whose containers emit structured predictions survives the
    feedback join (the _default_loss fix, end to end)."""
    from repro_torch.core.interfaces import Feedback

    def structured(x):
        return [{"y": np.asarray([1.0, 0.0]), "confidence": 1.0}
                for _ in range(len(x))]

    clip = make_clipper(
        {"m": structured}, "exp4", slo=0.02,
        latency_models={"m": linear_latency(
            0.001, 1e-5, rng=np.random.default_rng(0))},
        device=CPU)
    x = np.ones(4, np.float32)
    clip.submit(x, arrival_time=0.0)
    clip.run()
    clip.feedback(Feedback(0, x, 0))           # must not raise


def test_late_query_renders_on_first_arrival_past_deadline():
    """Deadline fires with zero predictions: the first model to return
    renders a partial answer immediately — the query (or pipeline stage)
    must not wait out the remaining stragglers."""
    clip = make_clipper(
        {"a": lambda x: np.zeros((len(x), 10), np.float32),
         "b": lambda x: np.zeros((len(x), 10), np.float32)},
        "exp4", slo=0.02, use_cache=False,
        latency_models={
            "a": linear_latency(0.05, 0.0, rng=np.random.default_rng(1)),
            "b": linear_latency(5.0, 0.0, rng=np.random.default_rng(2))},
        device=CPU)
    qid = clip.submit(np.ones(4, np.float32), arrival_time=0.0)
    clip.run(until=1.0)                 # model b would only land at t=5
    pred = clip.results[qid]
    assert pred.missing_models == ("b",)
    assert pred.latency == pytest.approx(0.05)


def test_pipeline_cli_report_out_and_meta(tmp_path):
    from repro_torch.pipeline.run import main
    out = tmp_path / "rep.json"
    rc = main(["--scenario", "cascade", "--seed", "3", "--duration", "0.2",
               "--report-out", str(out), "--device", CPU])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["schema"] == "repro.metrics/v1"
    assert rep["stack"] == "pipeline"
    assert rep["meta"] == {"trace_seed": 3,
                           "trace_generator": "poisson_trace"}
    assert rep["pipeline"]["graph"]["output"] == "output"
    assert rep["pipeline"]["slo_split"]["slo"] == rep["slo"]["target_s"]

