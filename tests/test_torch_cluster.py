"""Control plane (DESIGN.md §10) of the port: the cluster CLI's
documents held against the reference's, then the port-side copy of
``tests/test_cluster.py`` (dynamic replica sets, autoscaling under a flash
crowd, SLO-aware admission control, heterogeneous routing, and the
deterministic ``repro_torch.cluster.run`` loop — all exact oracles under
the virtual clock), on the CPU.

Parity: ``python -m repro_torch.cluster.run --device cpu`` and the
reference's CLI, run in process on the flash-crowd scenario (seed 0), write
the same report, span log, time series and audit doc, byte for byte, on the
frontend and pipeline stacks and under a crash fault with and without
recovery. The lmserver stack with admission control serves the reduced LM
on each package's own weights; its report is the reference's but
``engine.attention_backend`` and the port's ``engine.decode.graph`` and
``engine.prefill.graph`` (the report does not depend on the tokens: fixed
lengths, no EOS), and its other documents are the reference's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.cluster import run as jrun
from repro_torch.cluster import (ClusterPlan, LeastExpectedCompletion,
                                 SloAdmission, cluster_scenario, least_loaded,
                                 run_plan, run_plan_json)
from repro_torch.cluster import run as trun
from repro_torch.core import metrics as M
from repro_torch.core.batching import AIMDController, BatchQueue
from repro_torch.core.containers import (ReplicaSet, TorchModelContainer,
                                         linear_latency)
from repro_torch.core.frontend import make_clipper
from repro_torch.core.interfaces import Query
from repro_torch.workloads import poisson_trace, query_trace

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
DOCS = ("report", "trace", "series", "audit")
CRASH = "crash:m0:0@0.25:0.9"


def _cli(main, tmp_path, tag, args, device=()):
    """Run one CLI in process with every document written; returns the
    documents' bytes."""
    files = {d: tmp_path / f"{tag}.{d}.json" for d in DOCS}
    assert main(["--scenario", "flash_crowd", "--seed", "0",
                 "--report-out", str(files["report"]),
                 "--trace-out", str(files["trace"]),
                 "--timeseries-out", str(files["series"]),
                 "--audit-out", str(files["audit"])]
                + list(args) + list(device)) == 0
    return {d: f.read_bytes() for d, f in files.items()}


@pytest.mark.parametrize("args", [
    [], ["--stack", "pipeline"], ["--fault", CRASH],
    ["--fault", CRASH, "--no-recovery"]],
    ids=["frontend", "pipeline", "crash", "crash-no-recovery"])
def test_cluster_documents_byte_identical(tmp_path, args):
    want = _cli(jrun.main, tmp_path, "j", args)
    got = _cli(trun.main, tmp_path, "t", args, ["--device", CPU])
    for d in DOCS:
        assert got[d] == want[d], d
    rep = json.loads(got["report"])
    assert len(json.loads(got["trace"])["spans"]) > 0
    if "--fault" in args:
        # the fault run's counts, as the recovery benchmark reads them
        assert rep["faults"]["crashes"] >= 1
        if "--no-recovery" in args:
            assert rep["faults"]["detected"] == 0
            assert rep["queries"]["completed"] < rep["queries"]["submitted"]
        else:
            assert rep["faults"]["detected"] >= 1
            assert rep["faults"]["recovered"] >= 1


def test_lmserver_stack_with_admission_matches_reference(tmp_path):
    args = ["--stack", "lmserver", "--admission", "shed"]
    want = _cli(jrun.main, tmp_path, "j", args)
    got = _cli(trun.main, tmp_path, "t", args, ["--device", CPU])
    jrep, trep = (json.loads(x["report"]) for x in (want, got))
    assert jrep["engine"]["attention_backend"] == "jnp"
    assert trep["engine"]["attention_backend"] == "plain"
    assert trep["engine"]["decode"].pop("graph") is False
    assert trep["engine"]["prefill"].pop("graph") is False
    jrep["engine"]["attention_backend"] = "plain"
    assert trep == jrep
    assert trep["cluster"]["plan"]["admission"] == "shed"
    assert trep["queries"]["completed"] > 0
    for d in DOCS[1:]:
        assert got[d] == want[d], d


def test_python_m_cluster_run_matches_reference(tmp_path):
    """The module entry points, as a user runs them: the same report."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = {}
    for tag, mod, extra in (("j", "repro.cluster.run", []),
                            ("t", "repro_torch.cluster.run",
                             ["--device", CPU])):
        out = tmp_path / f"{tag}.json"
        subprocess.run([sys.executable, "-m", mod, "--scenario",
                        "flash_crowd", "--seed", "0", "--report-out",
                        str(out)] + extra, check=True, env=env, cwd=ROOT,
                       timeout=300)
        outs[tag] = out.read_bytes()
    assert outs["t"] == outs["j"]


def test_cluster_entry_points_run_on_the_card_or_raise(monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = cluster_scenario("poisson", duration=0.1)
    for stack in ("frontend", "pipeline", "lmserver"):
        with pytest.raises(RuntimeError, match="cuda"):
            run_plan(ClusterPlan(scenario=sc, stack=stack))
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--scenario", "poisson", "--report-out",
                   str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
    with pytest.raises(SystemExit):                  # no such device
        trun.main(["--device", "meta"])
    # the plan's device is not reported
    assert "device" not in ClusterPlan(scenario=sc, device=CPU).describe()


# ---------------------------------------------------------------------------
# port-side copy of tests/test_cluster.py
# ---------------------------------------------------------------------------


def _fn(x):
    return np.zeros((len(x), 10), np.float32)


def _container(mid="m", base=0.002, per_item=1e-4, seed=0):
    return TorchModelContainer(mid, _fn, latency_model=linear_latency(
        base, per_item, rng=np.random.default_rng(seed)))


def _rs(n=2, **kw):
    return ReplicaSet([_container(seed=i, **kw) for i in range(n)],
                      lambda: AIMDController(0.02))


# ---------------------------------------------------------------------------
# dynamic ReplicaSet: add / retire / drain
# ---------------------------------------------------------------------------

def test_add_replica_grows_live_set_and_attaches_metrics():
    rs = _rs(1)
    reg = M.MetricsRegistry(0.02)
    rs.attach_metrics(reg)
    assert rs.n_live == 1
    ri = rs.add_replica(_container(seed=9), now=1.5)
    assert ri == 1 and rs.n_live == 2
    assert rs.free_at[1] == 1.5
    assert rs.queues[1].metrics is reg and rs.queues[1].model_id == "m"


def test_retire_requeues_backlog_and_preserves_inflight():
    rs = _rs(2)
    q1 = Query(1, np.zeros(4), 0, 0.0, deadline=0.02)
    q2 = Query(2, np.zeros(4), 0, 0.001, deadline=0.021)
    rs.queues[1].put(q1)
    rs.queues[1].put(q2)
    rs.free_at[1] = 0.5                      # replica 1 mid-batch (in flight)
    rs.retire_replica(1, now=0.0)
    # backlog moved, nothing dropped; new work no longer routes there
    assert len(rs.queues[1]) == 0 and len(rs.queues[0]) == 2
    assert rs.routable() == [0]
    # the in-flight batch has not completed: slot still draining, not reaped
    assert rs.draining[1] and not rs.retired[1]
    rs.reap(0.4)
    assert not rs.retired[1]                 # still busy at t=0.4
    rs.reap(0.5)
    assert rs.retired[1] and not rs.draining[1]
    # indices stay valid for in-flight completion events: slot never reused
    assert len(rs.replicas) == 2


def test_retire_last_live_replica_refused():
    rs = _rs(1)
    with pytest.raises(ValueError):
        rs.retire_replica(0, now=0.0)
    # the refused call must not leave the replica wedged in draining state
    assert rs.routable() == [0] and not rs.draining[0]


def test_requeue_merges_by_arrival_order():
    make = lambda: BatchQueue(AIMDController(0.02))
    a, b = make(), make()
    a.put(Query(1, 0, 0, 0.3))
    b.put(Query(2, 0, 0, 0.1))
    b.put(Query(3, 0, 0, 0.5))
    moved = a.requeue_to(b)
    assert moved == 1 and len(a) == 0
    assert [q.query_id for q in b._q] == [2, 1, 3]


# ---------------------------------------------------------------------------
# satellite: linear_latency default streams are decorrelated
# ---------------------------------------------------------------------------

def test_linear_latency_default_streams_independent():
    a = linear_latency(0.001, 0.0, jitter=0.5)
    b = linear_latency(0.001, 0.0, jitter=0.5)
    assert [a(1) for _ in range(8)] != [b(1) for _ in range(8)]
    # explicit rngs with one seed still produce identical streams
    c = linear_latency(0.001, 0.0, jitter=0.5, rng=np.random.default_rng(4))
    d = linear_latency(0.001, 0.0, jitter=0.5, rng=np.random.default_rng(4))
    assert [c(1) for _ in range(8)] == [d(1) for _ in range(8)]


# ---------------------------------------------------------------------------
# heterogeneous routing
# ---------------------------------------------------------------------------

def _hetero_clipper(router):
    fast = TorchModelContainer("m", _fn, latency_model=linear_latency(
        0.001, 1e-4, rng=np.random.default_rng(1)))
    slow = TorchModelContainer("m", _fn, latency_model=linear_latency(
        0.010, 1e-3, rng=np.random.default_rng(2)))
    rs = ReplicaSet([fast, slow], lambda: AIMDController(0.02))
    from repro_torch.core.frontend import Clipper
    from repro_torch.core.selection import Exp4Policy
    clip = Clipper({"m": rs}, Exp4Policy(["m"], device=CPU), slo=0.02,
                   use_cache=False, router=router)
    return clip, fast, slow


def test_lect_router_prefers_fast_replica():
    trace = query_trace(poisson_trace(400.0, 1.0, seed=5), seed=5, pool=0)
    lect_clip, lect_fast, lect_slow = _hetero_clipper(
        LeastExpectedCompletion())
    lect_clip.replay(trace)
    ll_clip, ll_fast, ll_slow = _hetero_clipper(least_loaded)
    ll_clip.replay(trace)
    # least-loaded splits ~evenly over the heterogeneous pair; LECT shifts
    # work onto the fast replica and wins the tail
    assert lect_fast.stats.queries > lect_slow.stats.queries
    assert lect_fast.stats.queries > ll_fast.stats.queries
    p99_lect = lect_clip.report()["latency_s"]["p99"]
    p99_ll = ll_clip.report()["latency_s"]["p99"]
    assert p99_lect < p99_ll


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_admission_shed_under_overload_bounds_tail():
    over = cluster_scenario("poisson", rate=1500.0, duration=1.0)
    shed = run_plan(ClusterPlan(scenario=over, autoscale=False,
                                admission="shed", device=CPU))
    noadm = run_plan(ClusterPlan(scenario=over, autoscale=False, device=CPU))
    assert shed["admission"]["shed"] > 0
    assert (shed["queries"]["completed"] + shed["admission"]["shed"]
            == shed["queries"]["submitted"])
    # early shedding keeps the *served* tail far below the collapse the
    # un-protected run suffers
    assert shed["latency_s"]["p99"] < noadm["latency_s"]["p99"] / 5
    # sheds count against attainment — the controller can't game the metric
    assert shed["slo"]["attainment"] <= (
        shed["queries"]["completed"] / shed["queries"]["submitted"])


def test_shed_qids_partition_results():
    """Every submitted qid lands in exactly one of results / shed_qids, so
    callers can tell a shed query from a pending one."""
    clip = make_clipper(
        {"m": _fn}, "exp4", slo=0.020, use_cache=False,
        latency_models={"m": linear_latency(0.004, 4e-3,
                                            rng=np.random.default_rng(0))},
        admission=SloAdmission(policy="shed"), device=CPU)
    trace = query_trace(poisson_trace(1500.0, 0.5, seed=1), seed=1, pool=0)
    qids = clip.replay(trace)
    assert clip.shed_qids                        # overload: some were shed
    assert clip.shed_qids.isdisjoint(clip.results)
    assert set(qids) == clip.shed_qids | set(clip.results)
    assert len(clip.shed_qids) == clip.metrics.counter(M.QUERIES_SHED)


def test_admission_degrade_drops_slow_model_only():
    adm = SloAdmission(policy="degrade")
    clip = make_clipper(
        {"fast": _fn, "slow": _fn}, "exp4", slo=0.020, use_cache=False,
        latency_models={
            "fast": linear_latency(0.002, 1e-4,
                                   rng=np.random.default_rng(1)),
            "slow": linear_latency(0.060, 1e-3,
                                   rng=np.random.default_rng(2))},
        admission=adm, device=CPU)
    trace = query_trace(poisson_trace(300.0, 1.0, seed=3), seed=3, pool=0)
    clip.replay(trace)
    rep = clip.report()
    # the 60 ms model can never meet a 20 ms deadline: once its service
    # stats exist, every query degrades to the fast model and completes
    assert rep["admission"]["degraded"] > 0
    assert rep["admission"]["shed"] == 0
    assert rep["queries"]["completed"] == rep["queries"]["submitted"]
    assert rep["slo"]["violations"] == 0


# ---------------------------------------------------------------------------
# the acceptance oracle: autoscaled flash crowd vs fixed baseline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flash_crowd_runs():
    sc = cluster_scenario("flash_crowd")
    auto = run_plan(ClusterPlan(scenario=sc, autoscale=True, device=CPU))
    fixed = run_plan(ClusterPlan(scenario=sc, autoscale=False, device=CPU))
    return sc, auto, fixed


def test_autoscaler_beats_fixed_baseline_at_equal_steady_state(
        flash_crowd_runs):
    sc, auto, fixed = flash_crowd_runs
    # equal steady-state provisioning: both runs start (and the autoscaled
    # one ends) at the scenario's replica count
    assert sc.replicas == 1
    assert auto["scenario"]["replicas"] == fixed["scenario"]["replicas"] == 1
    assert auto["slo"]["attainment"] > fixed["slo"]["attainment"]
    # same offered load on both runs
    assert auto["queries"]["submitted"] == fixed["queries"]["submitted"]


def test_autoscaler_scales_up_then_back_down(flash_crowd_runs):
    _, auto, _ = flash_crowd_runs
    a = auto["cluster"]["autoscalers"][0]
    assert a["peak_live"] > 1                 # grew into the burst
    assert a["live"] == 1                     # drained back after it
    assert a["added"] >= a["peak_live"] - 1
    assert a["retired"] == a["added"]         # every scale-up was unwound
    # the timeline must actually visit the peak and return
    lives = [live for _, live in a["timeline"]]
    assert max(lives) == a["peak_live"] and lives[-1] == 1
    # drained replicas never lose work: everything submitted completes
    assert auto["queries"]["completed"] == auto["queries"]["submitted"]


def test_autoscaled_report_byte_identical(flash_crowd_runs):
    sc, auto, _ = flash_crowd_runs
    again = run_plan(ClusterPlan(scenario=sc, autoscale=True, device=CPU))
    assert (json.dumps(auto, sort_keys=True)
            == json.dumps(again, sort_keys=True))


# ---------------------------------------------------------------------------
# cluster CLI + report provenance
# ---------------------------------------------------------------------------

def test_cluster_cli_report_out_and_meta(tmp_path):
    from repro_torch.cluster.run import main
    out = tmp_path / "rep.json"
    rc = main(["--scenario", "flash_crowd", "--seed", "3", "--duration",
               "0.5", "--report-out", str(out), "--device", CPU])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["schema"] == "repro.metrics/v1"
    assert rep["meta"] == {"trace_seed": 3,
                           "trace_generator": "flash_crowd_trace"}
    assert rep["cluster"]["plan"]["autoscale"] is True
    assert {"shed", "degraded", "shed_rate"} == set(rep["admission"])


def test_workloads_cli_report_out_flag(tmp_path):
    from repro_torch.workloads.run import main
    out = tmp_path / "rep.json"
    rc = main(["--scenario", "poisson", "--duration", "0.2",
               "--report-out", str(out), "--device", CPU])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["meta"]["trace_generator"] == "poisson_trace"
    assert rep["meta"]["trace_seed"] == rep["scenario"]["seed"]


def test_run_plan_json_deterministic_lmserver():
    sc = cluster_scenario("poisson", duration=0.05, rate=200.0, lm_requests=4,
                          slots=2, prompt_len=4, max_new_tokens=2)
    plan = ClusterPlan(scenario=sc, stack="lmserver", admission="shed",
                       device=CPU)
    assert run_plan_json(plan) == run_plan_json(plan)
