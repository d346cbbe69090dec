"""Fault injection, failure detection, and hedged-retry recovery
(repro_torch.faults + Clipper RecoveryPolicy, DESIGN.md §14): the port-side
copy of ``tests/test_faults.py``, on the CPU (``device="cpu"``), plus the
fault plan's seeded streams held against the reference's.

Ground truth (the plan crashing containers) is strictly separated from
observation (the frontend detecting missed completions) — these tests cover
both sides plus the recovery value claim: a crashing replica with recovery
on loses nothing, while the no-recovery baseline silently drops queries."""

import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.core import containers as jcontainers
from repro_torch import faults as tfaults
from repro_torch.cluster import (ClusterPlan, SloAdmission, cluster_scenario,
                                 run_plan, run_plan_json)
from repro_torch.cluster.admission import expected_delay
from repro_torch.core import metrics as M
from repro_torch.core.batching import AIMDController, BatchQueue
from repro_torch.core.containers import (ContainerCrashed, ReplicaSet,
                                         TorchModelContainer, TransientError,
                                         linear_latency)
from repro_torch.core.frontend import Clipper
from repro_torch.core.interfaces import Query
from repro_torch.core.selection import Exp4Policy
from repro_torch.core.straggler import render_without
from repro_torch.faults import (FaultPlan, RecoveryPolicy, RequestFaults,
                                attach_faults, parse_fault)
from repro_torch.metrics.validate import validate_report
from repro_torch.obs.tracer import Tracer


def _fn(x):
    return np.zeros((len(x), 10), np.float32)


def _container(mid="m", base=0.002, per_item=1e-4, seed=0):
    return TorchModelContainer(mid, _fn, latency_model=linear_latency(
        base, per_item, rng=np.random.default_rng(seed)))


def _clip(n=2, *, recovery=None, faults=(), slo=0.05, fault_seed=0, **kw):
    rs = ReplicaSet([_container(seed=10 + i) for i in range(n)],
                    lambda: AIMDController(slo))
    clip = Clipper({"m": rs}, Exp4Policy(["m"], device="cpu"), slo=slo,
                   use_cache=False, recovery=recovery, **kw)
    if faults:
        attach_faults(clip.replica_sets,
                      FaultPlan.from_specs(faults, seed=fault_seed))
    return clip, rs


def _drive(clip, n=20, dt=0.004):
    qids = []
    for i in range(n):
        clip.run(until=i * dt)      # interleave events with arrivals
        qids.append(clip.submit(np.full(4, i, np.float32),
                                arrival_time=i * dt))
    clip.run()
    return qids


# ---------------------------------------------------------------------------
# plan: spec grammar, validation, seeded determinism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "crash:m0:0@0.25",
    "crash:m0:1@0.25:0.9",
    "flaky:m1:0:0.3",
    "slow:m0:2:4",
    "slow:m0:0:2.5@0.1:0.4",
])
def test_parse_fault_round_trips(spec):
    assert parse_fault(spec).describe() == spec


@pytest.mark.parametrize("spec", [
    "explode:m0:0@1",              # unknown kind
    "crash:m0:0",                  # crash needs @<at>
    "crash:m0:0@0.5:0.5",          # recover_at must be > at
    "flaky:m0:0:1.5",              # p out of [0, 1]
    "slow:m0:0:0",                 # factor must be > 0
    "crash:m0:x@1",                # non-int replica
])
def test_parse_fault_rejects(spec):
    with pytest.raises(ValueError):
        parse_fault(spec)


def test_replica_faults_crash_window_and_multiplier():
    rf = FaultPlan.from_specs(
        ["crash:m:0@0.2:0.5", "slow:m:0:3@0.1:0.3"]).for_replica("m", 0)
    assert not rf.crashed(0.1)
    assert rf.crashed(0.2) and rf.crashed(0.49)
    assert not rf.crashed(0.5)                      # recovered
    assert rf.multiplier(0.05) == 1.0
    assert rf.multiplier(0.15) == 3.0
    assert rf.multiplier(0.35) == 1.0
    with pytest.raises(ContainerCrashed):
        rf.check_dispatch(0.3)
    # crash striking mid-service loses the batch even though dispatch ran
    rf2 = FaultPlan.from_specs(["crash:m:0@0.2"]).for_replica("m", 0)
    rf2.check_service(0.0, 0.1)                     # finishes before crash
    with pytest.raises(ContainerCrashed):
        rf2.check_service(0.15, 0.1)


def test_transient_streams_deterministic_per_seed():
    def stream(seed):
        rf = FaultPlan.from_specs(["flaky:m:0:0.5"],
                                  seed=seed).for_replica("m", 0)
        out = []
        for _ in range(64):
            try:
                rf.check_dispatch(0.0)
                out.append(0)
            except TransientError:
                out.append(1)
        return out

    assert stream(7) == stream(7)
    assert stream(7) != stream(8)
    assert 0 < sum(stream(7)) < 64


def test_attach_faults_validates_targets():
    _, rs = _clip(2)
    with pytest.raises(KeyError):
        attach_faults({"m": rs}, FaultPlan.from_specs(["crash:nope:0@0"]))
    with pytest.raises(KeyError):
        attach_faults({"m": rs}, FaultPlan.from_specs(["crash:m:5@0"]))
    assert attach_faults({"m": rs},
                         FaultPlan.from_specs(["crash:m:0@0"])) == 1
    assert rs.has_faults and rs.replicas[0].faults is not None


# ---------------------------------------------------------------------------
# containers: the injection site
# ---------------------------------------------------------------------------

def test_container_crash_counts_failure():
    c = _container()
    attach_faults({"m": ReplicaSet([c], lambda: AIMDController(0.02))},
                  FaultPlan.from_specs(["crash:m:0@0.1"]))
    outs, service = c.pred_batch_timed([np.zeros(4)], now=0.0)
    assert len(outs) == 1 and service > 0
    with pytest.raises(ContainerCrashed):
        c.pred_batch_timed([np.zeros(4)], now=0.2)
    assert c.stats.failures == 1
    # the legacy signature stays fault-oblivious (no virtual now, no checks)
    outs, _ = c.pred_batch_timed([np.zeros(4)])
    assert len(outs) == 1


def test_container_transient_and_slow_service():
    flaky = _container()
    attach_faults({"m": ReplicaSet([flaky], lambda: AIMDController(0.02))},
                  FaultPlan.from_specs(["flaky:m:0:1"]))
    with pytest.raises(TransientError):
        flaky.pred_batch_timed([np.zeros(4)], now=0.0)
    assert flaky.stats.failures == 1
    # slow: service scales by the factor against an identically-seeded twin
    a, b = _container(seed=3), _container(seed=3)
    attach_faults({"m": ReplicaSet([b], lambda: AIMDController(0.02))},
                  FaultPlan.from_specs(["slow:m:0:4"]))
    _, sa = a.pred_batch_timed([np.zeros(4)], now=0.0)
    _, sb = b.pred_batch_timed([np.zeros(4)], now=0.0)
    assert sb == pytest.approx(4 * sa, rel=1e-9)


def test_requeue_to_keep_filter():
    make = lambda: BatchQueue(AIMDController(0.02))
    a, b = make(), make()
    for i, t in enumerate((0.3, 0.1, 0.5)):
        a.put(Query(i, 0, 0, t))
    moved = a.requeue_to(b, keep=lambda q: q.query_id != 1)
    assert moved == 2 and len(a) == 0           # dropped query not moved
    assert [q.query_id for q in b._q] == [0, 2]


def test_render_without_deterministic():
    preds = {"a": np.full(3, 1.0, np.float32),
             "b": np.full(3, 3.0, np.float32),
             "c": np.full(3, 8.0, np.float32)}
    y = render_without(["a", "b", "c"], preds, ["c"])
    assert np.allclose(y, 2.0)                  # mean of the survivors
    again = render_without(["a", "b", "c"], preds, ["c"])
    assert np.array_equal(y, again)
    # excluding every model leaves nothing to render — explicit error, not
    # a silent zero answer
    with pytest.raises(ValueError):
        render_without(["a", "b", "c"], preds, ["a", "b", "c"])


# ---------------------------------------------------------------------------
# frontend recovery: detect, requeue, retry, hedge, rejoin
# ---------------------------------------------------------------------------

def test_crash_detected_retried_and_nothing_lost():
    clip, rs = _clip(2, recovery=RecoveryPolicy(),
                     faults=("crash:m:0@0",))
    qids = _drive(clip)
    assert len(clip.results) == len(qids)       # every query answered
    assert rs.replicas[0].fail and 0 in rs.suspected
    assert clip.metrics.counter(M.FAULTS_CRASHES) >= 1
    assert clip.metrics.counter(M.FAULTS_DETECTED) == 1
    assert clip.metrics.counter(M.FAULTS_RETRIES) >= 1
    rep = clip.report()
    assert rep["faults"]["detected"] == 1
    assert rep["per_model"]["m"]["failures"] >= 1
    assert rep["per_model"]["m"]["retries"] >= 1
    assert validate_report(rep) == []


def test_no_recovery_baseline_loses_queries():
    """The value claim: with the detector off, a crashed replica is a black
    hole — batches vanish with no completion event and those queries never
    finish. Recovery on the same fault plan completes everything."""
    base, _ = _clip(2, recovery=None, faults=("crash:m:0@0",))
    _drive(base)
    rec, _ = _clip(2, recovery=RecoveryPolicy(), faults=("crash:m:0@0",))
    _drive(rec)
    lost = base.metrics.counter(M.QUERIES_SUBMITTED) \
        - base.metrics.counter(M.QUERIES_COMPLETED)
    assert lost > 0
    assert rec.metrics.counter(M.QUERIES_COMPLETED) \
        == rec.metrics.counter(M.QUERIES_SUBMITTED)


def test_crash_then_recover_rejoins_routing():
    clip, rs = _clip(2, recovery=RecoveryPolicy(),
                     faults=("crash:m:0@0:0.06",))
    qids = _drive(clip, n=40, dt=0.005)         # arrivals span the recovery
    assert len(clip.results) == len(qids)
    assert clip.metrics.counter(M.FAULTS_DETECTED) == 1
    assert clip.metrics.counter(M.FAULTS_RECOVERED) == 1
    assert not rs.replicas[0].fail and not rs.suspected
    assert 0 in rs.routable()
    # the probe reset the stale busy estimate so the replica is routable
    # immediately, not after its pre-crash free_at drains
    assert rs.free_at[0] <= clip.now


def test_transient_errors_fail_fast_and_exhaust():
    # a single always-flaky replica: every dispatch errors, every retry
    # errors again, so the per-query budget exhausts deterministically
    pol = RecoveryPolicy(max_retries=2, hedge=False)
    clip, _ = _clip(1, recovery=pol, faults=("flaky:m:0:1",))
    qids = _drive(clip, n=5)
    assert clip.metrics.counter(M.FAULTS_TRANSIENT) >= 5
    assert clip.metrics.counter(M.FAULTS_RETRIES) == 2 * len(qids)
    assert clip.metrics.counter(M.FAULTS_RETRY_EXHAUSTED) >= len(qids)
    assert len(clip.results) == 0               # no replica ever answered


def test_hedge_first_result_wins_with_exact_attribution():
    # replica 0 browns out (30x service) after a healthy warm-up, so its
    # batches suddenly outlive the history-based hedge threshold and
    # re-dispatch on replica 1, which answers first. The detector is
    # floored out of the way so hedging is isolated.
    tr = Tracer(sample_rate=1.0, seed=0)
    pol = RecoveryPolicy(min_timeout=10.0, hedge=True, hedge_min=0.01)
    clip, rs = _clip(2, recovery=pol, faults=("slow:m:0:30@0.02:10",),
                     tracer=tr)
    qids = _drive(clip)
    assert len(clip.results) == len(qids)
    assert clip.metrics.counter(M.FAULTS_HEDGES) >= 1
    assert clip.metrics.counter(M.FAULTS_HEDGE_WINS) >= 1
    assert clip.metrics.counter(M.FAULTS_SLOW) >= 1
    assert clip.report()["per_model"]["m"]["hedges"] >= 1
    # satellite: attribution stays an exact partition when a hedge wins —
    # every attributed root sums to its own end-to-end latency, and the
    # run-level fractions sum to 1
    roots = [s for s in tr.spans()
             if s.parent_id is None and s.kind == "span"
             and (s.attrs or {}).get("attribution")]
    assert roots
    for r in roots:
        assert sum(r.attrs["attribution"].values()) \
            == pytest.approx(r.end - r.start, abs=1e-9)
    att = tr.attribution_report()
    assert sum(c["fraction"] for c in att["components"].values()) \
        == pytest.approx(1.0, abs=1e-6)


def test_recovery_runs_deterministic():
    def run():
        clip, _ = _clip(2, recovery=RecoveryPolicy(),
                        faults=("crash:m:0@0:0.04", "flaky:m:1:0.2"))
        _drive(clip)
        return clip.report_json()
    assert run() == run()


def test_zero_overhead_without_plan():
    clip, rs = _clip(2)
    qids = _drive(clip)
    assert len(clip.results) == len(qids)
    assert clip._batches == {}                  # detector never armed
    assert not rs.has_faults and not rs.suspected
    rep = clip.report()
    assert set(rep["faults"].values()) == {0}
    assert validate_report(rep) == []


def test_stage_job_on_dead_model_finalizes_failed():
    # every replica of the stage's model is a permanent black hole with no
    # recovery: the stage must still finalize (empty, at the deadline) so a
    # pipeline never wedges on it — the executor counts stages_failed
    clip, _ = _clip(1, faults=("crash:m:0@0",))
    calls = []
    clip.submit_stage(["m"], np.zeros(4, np.float32), deadline=0.03,
                      finalize=lambda p, miss, late: calls.append(
                          (dict(p), miss, late)))
    clip.run()
    assert calls == [({}, ("m",), True)]


def test_validator_rejects_broken_faults_section():
    clip, _ = _clip(1)
    _drive(clip, n=3)
    rep = clip.report()
    assert validate_report(rep) == []
    bad = {**rep, "faults": {**rep["faults"], "detected": -1}}
    assert any("faults" in e for e in validate_report(bad))
    del bad["faults"]
    assert any("faults" in e for e in validate_report(bad))


# ---------------------------------------------------------------------------
# admission under total failure (satellite: SloAdmission + candidates())
# ---------------------------------------------------------------------------

def test_expected_delay_infinite_when_all_replicas_failed():
    _, rs = _clip(2)
    for r in rs.replicas:
        r.fail = True
    assert expected_delay(rs, 0.0) == float("inf")
    # regression: candidates() deliberately keeps a fallback slot so
    # recovery can drain enqueued work — admission must NOT use it
    assert rs.candidates() == [0, 1]
    assert rs.routable() == [] and rs.healthy() == []


def test_slo_admission_sheds_when_every_replica_is_down():
    clip, rs = _clip(2, admission=SloAdmission(policy="shed"))
    for r in rs.replicas:
        r.fail = True
    qid = clip.submit(np.zeros(4, np.float32), arrival_time=0.0)
    clip.run()
    assert qid in clip.shed_qids and qid not in clip.results
    assert clip.metrics.counter(M.QUERIES_SHED) == 1


# ---------------------------------------------------------------------------
# cluster control-loop integration
# ---------------------------------------------------------------------------

def _fault_plan(**kw):
    sc = cluster_scenario("flash_crowd", duration=0.4, seed=0)
    return ClusterPlan(scenario=sc, faults=("crash:m0:0@0.05:0.3",),
                       device="cpu", **kw)


def test_cluster_run_with_faults_deterministic_and_valid():
    rep = run_plan(_fault_plan())
    assert rep["faults"]["crashes"] >= 1
    assert rep["faults"]["detected"] >= 1
    assert rep["faults"]["recovered"] >= 1
    assert validate_report(rep) == []
    assert run_plan_json(_fault_plan()) == run_plan_json(_fault_plan())


def test_cluster_recovery_beats_no_recovery():
    rec = run_plan(_fault_plan())
    base = run_plan(_fault_plan(recovery=False))
    assert rec["queries"]["completed"] > base["queries"]["completed"]
    assert rec["slo"]["attainment"] > base["slo"]["attainment"]


def test_cli_rejects_bad_specs_and_lmserver_faults():
    from repro_torch.cluster.run import main
    with pytest.raises(SystemExit):
        main(["--scenario", "poisson", "--fault", "bogus:m0:0",
              "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--scenario", "poisson", "--stack", "lmserver",
              "--fault", "crash:m0:0@0.1", "--device", "cpu"])


# ---------------------------------------------------------------------------
# LM stack: per-request faults + cascade degradation
# ---------------------------------------------------------------------------

def test_request_faults_pure_and_calibrated():
    rf = RequestFaults(p_error=0.3, seed=5)
    picks = [rf.failed(i) for i in range(2000)]
    assert picks == [RequestFaults(p_error=0.3, seed=5).failed(i)
                     for i in range(2000)]
    assert 0.2 < sum(picks) / 2000 < 0.4
    assert picks != [RequestFaults(p_error=0.3, seed=6).failed(i)
                     for i in range(2000)]
    assert not any(RequestFaults(p_error=0.0).failed(i) for i in range(100))


def test_lmserver_marks_failed_requests():
    from repro_torch.configs.registry import ARCHITECTURES, reduced_config
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import LMServer

    cfg = reduced_config(ARCHITECTURES["smollm-360m"], num_layers=2,
                         d_model=64)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    srv = LMServer(model, device="cpu", slots=2, max_len=32,
                   faults=RequestFaults(p_error=1.0, seed=0))
    rng = np.random.default_rng(0)
    rids = [srv.submit(rng.integers(0, cfg.vocab_size, size=4),
                       max_new_tokens=2) for _ in range(3)]
    srv.run(params)
    assert all(srv.completed[rid].failed for rid in rids)
    assert all(len(srv.completed[rid].tokens) == 2 for rid in rids)
    assert srv.metrics.counter(M.FAULTS_TRANSIENT) == 3


class _StubEngine:
    """Quacks like LMServer for LMCascade unit tests: shared clock, private
    registry, recorded submissions, manual on_finish firing."""

    def __init__(self, clock, model_id):
        self.clock = clock
        self.metrics = M.MetricsRegistry(0.5)
        self.model_id = model_id
        self.shed = 0
        self.on_finish = None
        self.pending = False
        self.submitted = []
        self._next = 0

    def submit(self, prompt, max_new_tokens=16, now=None):
        rid = self._next
        self._next += 1
        self.submitted.append(rid)
        return rid

    def report(self):
        return self.metrics.report("lmserver")


def _stub_cascade(**kw):
    from repro_torch.core.metrics import VirtualClock
    from repro_torch.pipeline.cascade import LMCascade
    from repro_torch.serving.engine import Request

    clock = VirtualClock()
    draft = _StubEngine(clock, "draft")
    verify = _StubEngine(clock, "verify")
    casc = LMCascade(draft, verify, **kw)
    return casc, draft, verify, Request


def test_cascade_degrades_to_draft_when_verify_fails():
    casc, draft, verify, Request = _stub_cascade(
        escalate=lambda r: True)                # always verify
    cid = casc.submit(np.zeros(4, np.int32), now=0.0)
    dr = Request(0, np.zeros(4, np.int32), 4, 0.0,
                 tokens=[1, 2, 3], finish_time=0.1)
    draft.on_finish(dr)
    assert verify.submitted == [0]
    vr = Request(0, np.zeros(4, np.int32), 4, 0.1,
                 tokens=[9, 9, 9], finish_time=0.4, failed=True)
    verify.on_finish(vr)
    out = casc.results[cid]
    assert out["tier"] == "draft" and out["tokens"] == [1, 2, 3]
    assert out["latency"] == pytest.approx(0.4)  # honesty: verify-fail time
    assert casc.metrics.counter(M.QUERIES_DEGRADED) == 1


def test_cascade_escalates_failed_draft_as_retry():
    casc, draft, verify, Request = _stub_cascade(
        escalate=lambda r: False)               # would normally accept
    cid = casc.submit(np.zeros(4, np.int32), now=0.0)
    dr = Request(0, np.zeros(4, np.int32), 4, 0.0,
                 tokens=[1, 1, 1], finish_time=0.1, failed=True)
    draft.on_finish(dr)
    assert verify.submitted == [0]              # forced escalation
    assert casc.metrics.counter(M.FAULTS_RETRIES) == 1
    vr = Request(0, np.zeros(4, np.int32), 4, 0.1,
                 tokens=[5, 6, 7], finish_time=0.3)
    verify.on_finish(vr)
    assert casc.results[cid]["tier"] == "verify"
    assert casc.results[cid]["tokens"] == [5, 6, 7]


# ---------------------------------------------------------------------------
# the plan's seeded streams against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_request_fault_picks_match_reference(seed):
    for p in (0.05, 0.3, 0.9):
        assert ([RequestFaults(p_error=p, seed=seed).failed(i)
                 for i in range(500)]
                == [jfaults.RequestFaults(p_error=p, seed=seed).failed(i)
                    for i in range(500)])


@pytest.mark.parametrize("spec", [
    "crash:m:0@0.2:0.5", "flaky:m:1:0.4", "slow:m:0:2.5@0.1:0.4"])
def test_replica_faults_match_reference(spec):
    """The same specs and seed give the same crash windows, service
    multipliers and transient-error stream in both packages."""
    def trace(pkg, errors):
        plan = pkg.FaultPlan.from_specs([spec, "flaky:m:0:0.3"], seed=11)
        out = [plan.describe()]
        for r in (0, 1):
            rf = plan.for_replica("m", r)
            if rf is None:                  # no spec names this replica
                out.append(None)
                continue
            for t in np.linspace(0.0, 0.6, 25):
                t = float(t)
                try:
                    rf.check_dispatch(t)
                    verdict = "ok"
                except errors as e:
                    verdict = type(e).__name__
                out.append((rf.crashed(t), rf.multiplier(t), verdict))
        return out

    assert (trace(tfaults, (ContainerCrashed, TransientError))
            == trace(jfaults, (jcontainers.ContainerCrashed,
                               jcontainers.TransientError)))
