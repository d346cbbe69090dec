"""The observability documents' tooling on the port: the exporter
(``repro_torch.obs.export``) and the validator
(``repro_torch.metrics.validate``) held against the reference's, then the
port-side copies of ``tests/test_obs_fleet.py`` and of the cases of
``tests/test_obs.py`` that need the validator, the exporter or the
pipelines, on the CPU.

Parity: a flash-crowd cluster run (seed 0) with a tracer, a fleet sampler
and an audit log writes the same three documents in both packages; each
package's exporter turns each document into the same Chrome trace and CSV,
byte for byte, through the CLI; each package's validator accepts them, and
gives the same errors, in the same words, on the same malformed documents.
"""

import copy
import dataclasses
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import pytest

from repro.cluster import plan as jplan
from repro.metrics import validate as jvalidate
from repro.obs import AuditLog as JAuditLog
from repro.obs import BurnRateMonitor as JBurnRateMonitor
from repro.obs import FleetSampler as JFleetSampler
from repro.obs import Tracer as JTracer
from repro.obs import export as jexport
from repro_torch.cluster import plan as tplan
from repro_torch.cluster.plan import ClusterPlan, cluster_scenario, run_plan
from repro_torch.metrics import validate as tvalidate
from repro_torch.metrics.validate import (document_warnings, validate_audit,
                                          validate_document, validate_report,
                                          validate_timeseries, validate_trace)
from repro_torch.obs import (AuditLog, BurnRateMonitor, FleetSampler,
                             MonitorConfig, SeriesRing, Tracer)
from repro_torch.obs import export as texport
from repro_torch.obs.audit import ACTIONS
from repro_torch.obs.export import (chrome_audit, chrome_timeseries,
                                    chrome_trace, csv_audit, csv_timeseries)
from repro_torch.workloads.scenario import Scenario, ScenarioRunner

CPU = "cpu"
MODES = ("trace", "timeseries", "audit")


@pytest.fixture(scope="module")
def documents():
    """The flash-crowd cluster run's documents, from each package:
    ``{"j" | "t": {"report" | mode: dict}}``."""
    out = {}
    for tag, plan_mod, tracer, sampler, monitor, audit, kw in (
            ("j", jplan, JTracer, JFleetSampler, JBurnRateMonitor,
             JAuditLog, {}),
            ("t", tplan, Tracer, FleetSampler, BurnRateMonitor, AuditLog,
             {"device": CPU})):
        sc = plan_mod.cluster_scenario("flash_crowd", seed=0)
        tr = tracer(sample_rate=1.0, seed=0)
        sa = sampler(interval=0.05, monitor=monitor())
        au = audit()
        rep = plan_mod.run_plan(plan_mod.ClusterPlan(scenario=sc, **kw),
                                tracer=tr, sampler=sa, audit=au)
        out[tag] = {"report": json.loads(json.dumps(rep)),
                    "trace": tr.to_dict(), "timeseries": sa.to_dict(),
                    "audit": au.to_dict()}
    return out


def test_cluster_documents_equal(documents):
    for what in ("report",) + MODES:
        assert (json.dumps(documents["t"][what], sort_keys=True)
                == json.dumps(documents["j"][what], sort_keys=True)), what


@pytest.mark.parametrize("doc,mode,fmt", [
    ("trace", "spans", "chrome"), ("timeseries", "timeseries", "chrome"),
    ("timeseries", "timeseries", "csv"), ("audit", "audit", "chrome"),
    ("audit", "audit", "csv")])
def test_export_matches_reference(tmp_path, documents, doc, mode, fmt):
    """The CLI of each package on its own package's document, and the
    port's on the reference's: the same file."""
    outs = []
    for tag, main, d in (("j", jexport.main, documents["j"][doc]),
                         ("t", texport.main, documents["t"][doc]),
                         ("x", texport.main, documents["j"][doc])):
        src = tmp_path / f"{tag}.in.json"
        out = tmp_path / f"{tag}.out"
        src.write_text(json.dumps(d))
        assert main(["--mode", mode, "--format", fmt, str(src),
                     "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[1] == outs[0]
    assert outs[2] == outs[0]
    assert len(outs[0]) > 100


def test_export_refusals_match_reference(tmp_path, documents):
    """Both CLIs refuse a span log as CSV and a document of another kind
    than ``--mode`` names, with the same message."""
    src = tmp_path / "trace.json"
    src.write_text(json.dumps(documents["t"]["trace"]))
    for argv in (["--format", "csv", str(src)],
                 ["--mode", "audit", str(src)]):
        msgs = []
        for main in (jexport.main, texport.main):
            err = io.StringIO()
            with redirect_stderr(err), pytest.raises(SystemExit):
                main(argv)
            msgs.append(err.getvalue().split("error: ", 1)[1])
        assert msgs[1] == msgs[0]


def _mutations(docs):
    """Malformed documents, each with one defect the validator names."""
    rep, trace, ts, audit = (copy.deepcopy(docs[k]) for k in
                             ("report", "trace", "timeseries", "audit"))
    bad = []
    r = copy.deepcopy(rep)
    r["duration_s"], r["throughput_qps"] = 0, 12.0
    bad.append(r)
    r = copy.deepcopy(rep)
    del r["faults"]
    bad.append(r)
    r = copy.deepcopy(rep)
    r["latency_s"] = {"count": 3}
    bad.append(r)
    t = copy.deepcopy(trace)
    t["spans"][0] = dict(t["spans"][0], start=5.0, end=1.0)
    bad.append(t)
    t = copy.deepcopy(trace)
    t["attribution"] = {"queries": 2, "total_latency_s": 1.0,
                        "components": {"a": {"seconds": 0.7,
                                             "fraction": 0.7}}}
    bad.append(t)
    s = copy.deepcopy(ts)
    name = sorted(s["series"])[0]
    s["series"][name]["points"] = list(reversed(
        s["series"][name]["points"]))
    bad.append(s)
    a = copy.deepcopy(audit)
    a["total"] = a["total"] + 1
    bad.append(a)
    a = copy.deepcopy(audit)
    a["records"][0]["action"] = "explode"
    bad.append(a)
    bad.append({"schema": "nope"})
    bad.append({"schema": "repro.audit/v1"})
    return bad


def test_validator_matches_reference(documents):
    for what in ("report",) + MODES:
        assert tvalidate.validate_document(documents["t"][what]) == []
        assert jvalidate.validate_document(documents["t"][what]) == []
        assert (tvalidate.document_warnings(documents["t"][what])
                == jvalidate.document_warnings(documents["j"][what]))
    for doc in _mutations(documents["t"]):
        errs = tvalidate.validate_document(doc)
        assert errs, doc.get("schema")
        assert errs == jvalidate.validate_document(doc)


def test_validate_cli_matches_reference(tmp_path, documents):
    paths = []
    for i, doc in enumerate([documents["t"][w] for w in ("report",) + MODES]
                            + _mutations(documents["t"])[:4]):
        p = tmp_path / f"d{i}.json"
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    for argv in (paths[:4], paths, ["--strict"] + paths[:4]):
        got = []
        for main in (jvalidate.main, tvalidate.main):
            out, err = io.StringIO(), io.StringIO()
            with redirect_stdout(out), redirect_stderr(err):
                rc = main(argv)
            got.append((rc, out.getvalue(), err.getvalue()))
        assert got[1] == got[0]
    assert got[0][0] == 0 or "--strict" in argv


# ---------------------------------------------------------------------------
# port-side copies of tests/test_obs.py's validator, exporter and pipeline
# cases
# ---------------------------------------------------------------------------

_FE = dict(rate=200.0, duration=0.2, seed=11)
_LM = dict(duration=0.05, rate=200.0, lm_requests=5, slots=2,
           prompt_len=4, max_new_tokens=2, seed=11)


def _run_traced(stack, **kw):
    sc = Scenario("t", **kw)
    tr = Tracer(sample_rate=1.0, seed=sc.seed)
    rep = ScenarioRunner(sc, tracer=tr, device=CPU).run(stack)
    return rep, tr


def _run_pipeline_traced(shape="cascade"):
    from repro_torch.pipeline.scenario import pipeline_scenario, run_pipeline
    sc = dataclasses.replace(pipeline_scenario("pipeline"),
                             duration=0.2, rate=40.0, seed=11)
    tr = Tracer(sample_rate=1.0, seed=sc.seed)
    rep = run_pipeline(sc, shape, tracer=tr, device=CPU)
    return rep, tr


def _roots(tr, name):
    return [s for s in tr.spans()
            if s.parent_id is None and s.kind == "span" and s.name == name]


def test_pipeline_trace_byte_identical_per_seed():
    _, t1 = _run_pipeline_traced()
    _, t2 = _run_pipeline_traced()
    assert t1.to_json() == t2.to_json()
    assert len(t1.spans()) > 0


def test_pipeline_attribution_covers_stages_and_sums_to_one():
    rep, tr = _run_pipeline_traced()
    att = rep["latency_attribution"]
    assert att["queries"] > 0
    assert any(c.startswith("pipeline.stage.") for c in att["components"])
    assert sum(c["fraction"] for c in att["components"].values()) \
        == pytest.approx(1.0, abs=1e-6)
    for r in _roots(tr, "pipeline"):
        a = (r.attrs or {}).get("attribution")
        if a:
            assert sum(a.values()) == pytest.approx(r.end - r.start, abs=1e-9)


# ---------------------------------------------------------------------------
# span structure
# ---------------------------------------------------------------------------

def test_child_spans_nest_within_parent_bounds():
    for _, tr in (_run_traced("frontend", **_FE),
                  _run_traced("lmserver", **_LM)):
        doc = tr.to_dict()
        assert validate_trace(doc) == []           # includes nesting checks
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


def test_budget_annotations_present_on_roots_and_stages():
    _, tr = _run_traced("frontend", **_FE)
    assert all(r.budget_s is not None for r in _roots(tr, "query"))
    rep, tp = _run_pipeline_traced()
    stages = [s for s in tp.spans() if s.component == "pipeline.stage"]
    assert stages and all(s.budget_s is not None and s.budget_s > 0
                          for s in stages)
    # planner shares: each stage budget is bounded by the pipeline SLO
    slo = rep["slo"]["target_s"]
    assert all(s.budget_s <= slo + 1e-9 for s in stages)


# ---------------------------------------------------------------------------
# export + validation
# ---------------------------------------------------------------------------

def test_chrome_export_structure_and_determinism():
    _, tr = _run_traced("frontend", **_FE)
    doc = tr.to_dict()
    ct = chrome_trace(doc)
    evs = [e for e in ct["traceEvents"] if e["ph"] != "M"]
    assert evs
    for e in evs:
        assert e["ph"] in ("X", "i")
        assert e["ts"] >= 0
        if e["ph"] == "X":
            assert e["dur"] >= 0
    spans = {s["span_id"]: s for s in doc["spans"]}
    # microsecond conversion is exact for one known span
    s = next(iter(spans.values()))
    assert any(abs(e["ts"] - s["start"] * 1e6) < 1e-6 for e in evs)
    assert json.dumps(chrome_trace(doc), sort_keys=True) \
        == json.dumps(chrome_trace(doc), sort_keys=True)


def test_chrome_export_rejects_wrong_schema():
    with pytest.raises(ValueError):
        chrome_trace({"schema": "repro.metrics/v1", "spans": []})


def test_validator_accepts_real_reports_and_traces():
    rep, tr = _run_traced("frontend", **_FE)
    assert validate_report(rep) == []
    assert validate_trace(tr.to_dict()) == []
    assert validate_document(rep) == []
    assert validate_document({"schema": "nope"}) != []


def test_validator_flags_schema_violations():
    rep, tr = _run_traced("frontend", **_FE)
    bad = dict(rep)
    bad["duration_s"] = 0
    bad["throughput_qps"] = 12.0       # must be null on a degenerate span
    assert any("throughput_qps" in e for e in validate_report(bad))
    doc = tr.to_dict()
    doc["spans"] = [dict(doc["spans"][0], start=5.0, end=1.0)]
    assert any("end" in e for e in validate_trace(doc))
    att = {"queries": 2, "total_latency_s": 1.0,
           "components": {"a": {"seconds": 0.7, "fraction": 0.7}}}
    assert any("sum" in e for e in validate_trace(
        {**tr.to_dict(), "attribution": att}))


def test_validate_cli_roundtrip(tmp_path):
    from repro_torch.metrics.validate import main
    rep, tr = _run_traced("frontend", **_FE)
    rp = tmp_path / "report.json"
    tp = tmp_path / "trace.json"
    rp.write_text(json.dumps(rep))
    tp.write_text(tr.to_json())
    assert main([str(rp), str(tp)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "nope"}))
    assert main([str(bad)]) == 1


def test_export_cli_roundtrip(tmp_path):
    from repro_torch.obs.export import main
    _, tr = _run_traced("frontend", **_FE)
    src = tmp_path / "trace.json"
    out = tmp_path / "chrome.json"
    src.write_text(tr.to_json())
    assert main([str(src), "-o", str(out)]) == 0
    ct = json.loads(out.read_text())
    assert ct["traceEvents"]
    assert ct["otherData"]["schema"] == "repro.trace/v1"


# ---------------------------------------------------------------------------
# port-side copy of tests/test_obs_fleet.py
# ---------------------------------------------------------------------------

def _fleet(interval=0.05):
    return FleetSampler(interval=interval, monitor=BurnRateMonitor())


def _run_cluster(name="flash_crowd", *, sampler=None, audit=None, **kw):
    plan = ClusterPlan(scenario=cluster_scenario(name), device=CPU, **kw)
    return run_plan(plan, sampler=sampler, audit=audit)


# ---------------------------------------------------------------------------
# time-series ring + sampler mechanics
# ---------------------------------------------------------------------------

def test_series_ring_bounds_memory_and_counts_dropped():
    ring = SeriesRing(capacity=8)
    for i in range(20):
        ring.append(float(i), float(i * i))
    assert len(ring) == 8
    assert ring.total == 20
    assert ring.dropped == 12
    assert ring.points()[0] == [12.0, 144.0]
    assert ring.points()[-1] == [19.0, 361.0]


def test_sample_until_stamps_exact_interval_boundaries():
    seen = []
    s = FleetSampler(interval=0.05)
    s.add_probe(lambda now, dt: seen.append((now, dt)) or {"x": now})
    s.sample_until(0.26)
    s.sample_until(0.26)            # idempotent: no duplicate stamps
    assert [t for t, _ in seen] == pytest.approx([0.05, 0.1, 0.15, 0.2, 0.25])
    assert all(dt == 0.05 for _, dt in seen)
    pts = s.to_dict()["series"]["x"]["points"]
    assert [p[0] for p in pts] == pytest.approx([0.05, 0.1, 0.15, 0.2, 0.25])
    assert s.samples == 5


def test_sampler_document_schema_and_determinism():
    def doc():
        s = _fleet()
        s.add_probe(lambda now, dt: {"q": 2.0 * now})
        s.sample_until(0.5)
        return s.to_json()
    a, b = doc(), doc()
    assert a == b
    parsed = json.loads(a)
    assert parsed["schema"] == "repro.timeseries/v1"
    assert validate_timeseries(parsed) == []


# ---------------------------------------------------------------------------
# burn-rate monitor: unit-level fire/resolve at pinned ticks
# ---------------------------------------------------------------------------

class _FakeMetrics:
    def __init__(self):
        self.done = 0
        self.viol = 0
        self.shed = 0

    def counter(self, name, *, model=None):
        from repro_torch.core import metrics as M
        return {M.QUERIES_COMPLETED: self.done,
                M.SLO_VIOLATIONS: self.viol,
                M.QUERIES_SHED: self.shed}.get(name, 0)


def test_monitor_fires_and_resolves_at_pinned_ticks():
    cfg = MonitorConfig(objective=0.95, fast_window=0.2, slow_window=0.4,
                        burn_threshold=2.0)
    mon = BurnRateMonitor(cfg)
    m = _FakeMetrics()
    mon.bind(m)
    events = []
    for k in range(1, 21):                      # 0.05s ticks to t=1.0
        t = 0.05 * k
        m.done += 20
        if 0.3 < t <= 0.6:
            m.viol += 10                        # 50% error >> 10% budget*2
        events.extend(mon.observe(t))
    kinds = [(e["kind"], e["t"]) for e in events]
    assert kinds[0][0] == "fire"
    assert kinds[-1][0] == "resolve"
    assert len(kinds) == 2
    fire, resolve = events
    assert 0.3 < fire["t"] <= 0.6               # fires inside the bad window
    assert resolve["t"] > fire["t"]
    for key in ("burn_fast", "burn_slow", "error_fast", "error_slow",
                "threshold", "budget"):
        assert key in fire["evidence"]
    assert fire["evidence"]["burn_fast"] > cfg.burn_threshold
    assert mon.summary()["fired"] == 1 and mon.summary()["resolved"] == 1


def test_monitor_silent_when_healthy_or_unbound():
    mon = BurnRateMonitor()
    assert mon.observe(1.0) == []               # unbound: no metrics, no-op
    m = _FakeMetrics()
    mon.bind(m)
    for k in range(1, 40):
        m.done += 50                            # zero violations throughout
        assert mon.observe(0.05 * k) == []
    assert mon.summary()["fired"] == 0


def test_monitor_requires_both_windows_burning():
    # a one-tick error blip exceeds the fast window's burn but not the
    # slow window's -> multiwindow rule keeps the alert silent
    cfg = MonitorConfig(objective=0.95, fast_window=0.1, slow_window=1.0,
                        burn_threshold=2.0)
    mon = BurnRateMonitor(cfg)
    m = _FakeMetrics()
    mon.bind(m)
    fired = []
    for k in range(1, 30):
        t = 0.05 * k
        m.done += 40
        if k == 10:
            m.viol += 8                         # 20% of one tick's queries
        fired.extend(mon.observe(t))
    assert fired == []


# ---------------------------------------------------------------------------
# flash crowd end-to-end: alerts fire + resolve, byte-identical per seed
# ---------------------------------------------------------------------------

def test_flash_crowd_burn_alert_fires_and_resolves():
    sampler = _fleet()
    rep = _run_cluster("flash_crowd", sampler=sampler)
    events = sampler.to_dict()["events"]
    kinds = [e["kind"] for e in events]
    assert "fire" in kinds
    assert kinds[0] == "fire"                   # spike begins before recovery
    assert "resolve" in kinds
    fire_t = next(e["t"] for e in events if e["kind"] == "fire")
    resolve_t = next(e["t"] for e in events if e["kind"] == "resolve")
    assert fire_t < resolve_t                   # alert brackets the dip
    # the flash-crowd spike occupies the middle of the trace: the alert
    # must fire after load ramps and resolve once capacity catches up
    sc = cluster_scenario("flash_crowd")
    assert 0.0 < fire_t < sc.duration
    assert rep["queries"]["completed"] > 0


def test_flash_crowd_timeseries_and_audit_byte_identical():
    def run():
        sampler, audit = _fleet(), AuditLog()
        _run_cluster("flash_crowd", sampler=sampler, audit=audit)
        return sampler.to_json(), audit.to_json()
    (ts1, a1), (ts2, a2) = run(), run()
    assert ts1 == ts2
    assert a1 == a2
    assert validate_timeseries(json.loads(ts1)) == []
    assert validate_audit(json.loads(a1)) == []


def test_healthy_baseline_never_fires():
    sampler = _fleet()
    _run_cluster("poisson", sampler=sampler)
    assert sampler.to_dict()["events"] == []
    assert sampler.monitor.summary()["fired"] == 0


def test_alert_events_mirrored_into_span_log():
    sampler, tracer = _fleet(), Tracer(sample_rate=0.0, seed=0)
    sampler.bind(tracer=tracer)
    _run_cluster("flash_crowd", sampler=sampler)
    names = [s.name for s in tracer.spans()
             if s.trace_id == 0 and s.component == "obs.monitor"]
    assert "alert.fire" in names
    assert "alert.resolve" in names


def test_fleet_series_cover_the_vital_signs():
    sampler = _fleet()
    _run_cluster("flash_crowd", sampler=sampler)
    series = set(sampler.to_dict()["series"])
    for name in ("lambda", "throughput", "queue_depth.m0", "inflight.m0",
                 "replicas_live.m0", "est_service.m0", "aimd_budget.m0",
                 "slo.attainment_fast", "slo.burn_fast", "slo.alert_active"):
        assert name in series, name


# ---------------------------------------------------------------------------
# audit log: ring, evidence, decision counts
# ---------------------------------------------------------------------------

def test_audit_ring_bounds_but_counts_stay_exact():
    log = AuditLog(capacity=4)
    for i in range(10):
        log.record(float(i), "autoscaler", "grow", model="m0",
                   evidence={"lambda": float(i)})
    assert log.total == 10 and log.dropped == 6
    assert len(log.records()) == 4
    assert log.count("autoscaler", "grow") == 10    # exact despite drops
    assert [r["seq"] for r in log.records()] == [6, 7, 8, 9]
    assert validate_audit(log.to_dict()) == []


def test_validator_flags_unknown_actions_for_known_actors():
    log = AuditLog()
    log.record(0.0, "autoscaler", "explode")    # log accepts anything...
    errs = validate_audit(log.to_dict())
    assert any("explode" in e for e in errs)    # ...the validator objects
    assert "grow" in ACTIONS["autoscaler"]


def test_autoscaler_decisions_audited_with_evidence():
    audit = AuditLog()
    rep = _run_cluster("flash_crowd", audit=audit)
    per_model = rep["cluster"]["decisions"]["per_model"]
    grown = sum(row["grow"] for row in per_model.values())
    drained = sum(row["drain"] for row in per_model.values())
    assert grown > 0
    assert audit.count("autoscaler", "grow") == grown
    assert audit.count("autoscaler", "drain") == drained
    recs = [r for r in audit.records()
            if r["actor"] == "autoscaler" and r["action"] == "grow"]
    for r in recs:
        for key in ("lambda", "est_service_s", "backlog", "want", "live"):
            assert key in r["evidence"], key
    assert rep["cluster"]["decisions"]["audit"]["counts"] == \
        audit.summary()["counts"]


def test_admission_decisions_audited_with_expected_delay():
    audit = AuditLog()
    rep = _run_cluster("flash_crowd", audit=audit, admission="shed",
                       autoscale=False)
    shed = rep["cluster"]["decisions"]["shed"]
    assert shed > 0
    assert audit.count("admission", "shed") == shed
    rec = next(r for r in audit.records()
               if r["actor"] == "admission" and r["action"] == "shed")
    for key in ("slack_s", "expected_delay_s", "chosen"):
        assert key in rec["evidence"], key


def test_router_picks_audited_per_query():
    audit = AuditLog()
    rep = _run_cluster("poisson", audit=audit)
    routed = rep["queries"]["completed"]
    assert audit.count("router", "pick") >= routed > 0
    rec = next(r for r in audit.records() if r["actor"] == "router")
    assert "replica" in rec["evidence"]


def test_report_decisions_section_stable_without_audit():
    rep = _run_cluster("flash_crowd")
    dec = rep["cluster"]["decisions"]
    assert dec["audit"] is None                 # flag off -> no audit blob
    assert set(dec["per_model"]["m0"]) == {"grow", "drain"}
    assert dec["shed"] == 0                     # no admission policy active


# ---------------------------------------------------------------------------
# per-replica utilization in reports
# ---------------------------------------------------------------------------

def test_per_model_replica_utilization_in_report():
    rep = _run_cluster("flash_crowd")
    rows = rep["per_model"]["m0"]["replicas"]
    assert len(rows) >= 1
    for row in rows:
        assert set(row) >= {"replica", "busy_time", "utilization", "queries"}
        assert 0.0 <= row["utilization"] <= 1.0
    assert any(row["queries"] > 0 for row in rows)


# ---------------------------------------------------------------------------
# non-cluster stacks: sampled replay + LM engine probes
# ---------------------------------------------------------------------------

_LM = dict(duration=0.05, rate=200.0, lm_requests=6, slots=2,
           prompt_len=4, max_new_tokens=2, seed=11)


def test_frontend_sampled_replay_deterministic():
    def run():
        sc = Scenario("t", rate=200.0, duration=0.3, seed=11)
        sampler, audit = _fleet(0.05), AuditLog()
        rep = ScenarioRunner(sc, sampler=sampler, audit=audit,
                             device=CPU).run("frontend")
        return rep, sampler.to_json(), audit.to_json()
    (r1, t1, a1), (r2, t2, a2) = run(), run()
    assert t1 == t2 and a1 == a2
    assert r1 == r2
    assert json.loads(t1)["samples"] > 0


def test_lmserver_probe_emits_model_scoped_series():
    sc = Scenario("t", **_LM)
    sampler = _fleet(0.01)
    rep = ScenarioRunner(sc, sampler=sampler, device=CPU).run("lmserver")
    series = set(sampler.to_dict()["series"])
    assert any(s.startswith("lm.slots_active.") for s in series)
    assert any(s.startswith("lm.queue_depth.") for s in series)
    assert any(s.startswith("lm.lambda.") for s in series)
    assert rep["engine"]["prefill"]["rung_dispatches"]
    total = sum(rep["engine"]["prefill"]["rung_dispatches"].values())
    assert total == rep["engine"]["prefill"]["dispatches"]


def test_lmcascade_probes_do_not_collide():
    import dataclasses

    from repro_torch.pipeline.scenario import pipeline_scenario, run_lmcascade
    sc = dataclasses.replace(pipeline_scenario("pipeline"),
                             duration=0.05, rate=60.0, lm_requests=6,
                             slots=2, prompt_len=4, max_new_tokens=2, seed=11)
    sampler = _fleet(0.01)
    run_lmcascade(sc, sampler=sampler, device=CPU)
    doc = sampler.to_dict()
    assert validate_timeseries(doc) == []       # monotone t per series
    models = {s.rsplit(".", 1)[-1] for s in doc["series"]
              if s.startswith("lm.queue_depth.")}
    assert len(models) == 2                     # draft + verify, both present


# ---------------------------------------------------------------------------
# validation + truncation warnings
# ---------------------------------------------------------------------------

def test_validator_flags_broken_timeseries_and_audit():
    s = _fleet()
    s.add_probe(lambda now, dt: {"x": 1.0})
    s.sample_until(0.2)
    doc = s.to_dict()
    doc["series"]["x"]["points"][1][0] = 0.0    # break monotone t
    assert any("increasing" in e for e in validate_timeseries(doc))
    doc2 = s.to_dict()
    doc2["events"] = [{"t": 0.1, "kind": "resolve", "alert": "a",
                       "evidence": {}}]
    assert any("resolve" in e for e in validate_timeseries(doc2))
    log = AuditLog()
    log.record(0.0, "router", "pick", model="m0", evidence={})
    bad = log.to_dict()
    bad["counts"] = {"router.pick": 5}          # tally mismatch
    assert any("counts" in e for e in validate_audit(bad))
    assert validate_document({"schema": "repro.audit/v1"})


def test_truncation_surfaces_as_warnings_and_strict_exit(tmp_path):
    from repro_torch.metrics.validate import main as vmain
    log = AuditLog(capacity=2)
    for i in range(5):
        log.record(float(i), "router", "pick", model="m0", evidence={})
    doc = log.to_dict()
    assert any("dropped" in w for w in document_warnings(doc))
    p = tmp_path / "audit.json"
    p.write_text(log.to_json() + "\n")
    assert vmain([str(p)]) == 0                 # warnings alone don't fail
    assert vmain(["--strict", str(p)]) != 0     # unless --strict

    tr = Tracer(sample_rate=1.0, seed=0, capacity=2)
    for i in range(5):
        root = tr.start_trace("query", "frontend", float(i))
        tr.end_trace(root, i + 0.5)
    tp = tmp_path / "trace.json"
    tp.write_text(tr.to_json() + "\n")
    assert vmain([str(tp)]) == 0
    assert vmain(["--strict", str(tp)]) != 0


def test_report_trace_section_carries_dropped():
    sc = Scenario("t", rate=400.0, duration=0.2, seed=11)
    tr = Tracer(sample_rate=1.0, seed=11, capacity=4)
    rep = ScenarioRunner(sc, tracer=tr, device=CPU).run("frontend")
    assert rep["trace"]["dropped"] > 0
    assert any("dropped" in w for w in document_warnings(rep))


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def test_chrome_timeseries_counters_and_alert_instants():
    sampler = _fleet()
    _run_cluster("flash_crowd", sampler=sampler)
    out = chrome_timeseries(sampler.to_dict())
    evs = out["traceEvents"]
    counters = [e for e in evs if e["ph"] == "C"]
    instants = [e for e in evs if e["ph"] == "i"]
    assert len(counters) > 0
    assert {e["name"] for e in instants} >= {"alert.fire", "alert.resolve"}
    assert all(e["s"] == "p" for e in instants)
    assert out["otherData"]["schema"] == "repro.timeseries/v1"
    assert chrome_timeseries(sampler.to_dict()) == out   # deterministic


def test_chrome_audit_groups_actors_into_threads():
    audit = AuditLog()
    _run_cluster("flash_crowd", audit=audit)
    out = chrome_audit(audit.to_dict())
    evs = out["traceEvents"]
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"autoscaler", "router"} <= names
    assert all(e["ph"] in ("M", "i") for e in evs)


def test_csv_exports_roundtrip(tmp_path):
    sampler, audit = _fleet(), AuditLog()
    _run_cluster("flash_crowd", sampler=sampler, audit=audit)
    ts_csv = csv_timeseries(sampler.to_dict())
    assert ts_csv.splitlines()[0] == "series,t,value"
    assert len(ts_csv.splitlines()) == 1 + sum(
        r["total"] - r["dropped"]
        for r in sampler.to_dict()["series"].values())
    a_csv = csv_audit(audit.to_dict())
    assert a_csv.splitlines()[0] == "seq,t,actor,action,model,evidence"
    assert len(a_csv.splitlines()) == 1 + len(audit.records())


def test_export_cli_mode_dispatch(tmp_path):
    from repro_torch.obs.export import main as emain
    sampler, audit = _fleet(), AuditLog()
    _run_cluster("flash_crowd", sampler=sampler, audit=audit)
    ts, au = tmp_path / "ts.json", tmp_path / "audit.json"
    ts.write_text(sampler.to_json() + "\n")
    au.write_text(audit.to_json() + "\n")
    for src in (ts, au):
        out = tmp_path / (src.stem + ".chrome.json")
        assert emain([str(src), "-o", str(out)]) == 0    # --mode auto
        assert json.loads(out.read_text())["traceEvents"]
        csv_out = tmp_path / (src.stem + ".csv")
        assert emain([str(src), "--format", "csv",
                      "-o", str(csv_out)]) == 0
        assert csv_out.read_text().splitlines()
    with pytest.raises(SystemExit):                      # wrong schema
        emain(["--mode", "audit", str(ts), "-o", str(tmp_path / "x.json")])


def test_fault_events_exported_with_distinct_scope():
    from repro_torch.cluster.plan import run_plan
    plan = ClusterPlan(scenario=cluster_scenario("poisson"),
                       faults=("crash:m0:0@0.3:0.8",), device=CPU)
    tracer = Tracer(sample_rate=1.0, seed=0)
    run_plan(plan, tracer=tracer)
    out = chrome_trace(tracer.to_dict())
    fault_instants = [e for e in out["traceEvents"]
                      if e["ph"] == "i" and e["name"].startswith("fault.")]
    assert fault_instants
    assert all(e["s"] in ("g", "p") for e in fault_instants)


# ---------------------------------------------------------------------------
# zero overhead when off
# ---------------------------------------------------------------------------

def test_fleet_flags_off_leave_report_unchanged():
    base = json.dumps(_run_cluster("poisson"), sort_keys=True)
    again = json.dumps(_run_cluster("poisson"), sort_keys=True)
    assert base == again
    rep = json.loads(base)
    assert rep["cluster"]["decisions"]["audit"] is None
    assert "trace" not in rep


def test_flags_off_probe_machinery_never_runs():
    import numpy as np

    from repro_torch.core.frontend import make_clipper
    clip = make_clipper({"m0": lambda x: np.zeros((len(x), 10), np.float32)},
                        slo=0.02, device=CPU)
    for _ in range(20):
        clip.submit(np.zeros(4, np.float32))
    clip.run()
    assert clip.audit is None                   # no audit object exists
    assert clip._ts_prev == {}                  # probe never invoked


def test_build_fleet_returns_nothing_when_flags_off():
    import argparse

    from repro_torch.obs.cli import add_fleet_args, build_fleet
    p = argparse.ArgumentParser()
    add_fleet_args(p)
    args = p.parse_args([])
    assert build_fleet(args, p) == (None, None)
    args = p.parse_args(["--timeseries-out", "/tmp/x", "--audit-out",
                         "/tmp/y"])
    sampler, audit = build_fleet(args, p)
    assert sampler is not None and audit is not None
