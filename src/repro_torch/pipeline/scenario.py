"""Named pipeline scenarios: deterministic model sets + graph shapes wired
to the shared workload traces (DESIGN.md §12). Counterpart of
``repro.pipeline.scenario``: the same zoo and presets, with a ``device``
for the frontend pipelines' selection state and for the LM cascade, whose
construction (:func:`build_lmcascade`) is split from its drive loop
(:func:`drive_lmcascade`) so a caller can serve other weights.

``pipeline_models`` builds a graded model zoo from a scenario seed:

* ``prep``     — feature normalizer (cheap, every pipeline's root);
* ``cheap0/1`` — noisy draft scorers (fast, disagree on hard queries);
* ``accurate`` — near-oracle scorer (slow — the model a monolithic
                 deployment would serve everything with).

All quality is relative to one hidden true scorer, so draft *disagreement*
(``agreement_confidence``) genuinely correlates with being wrong — the
cascade escalates exactly the queries worth escalating. Latency models are
seeded per (scenario, model), so every run is a pure function of the
scenario (calibrated simulation, DESIGN.md §8).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.containers import TorchModelContainer, linear_latency
from repro_torch.core.metrics import MetricsRegistry, VirtualClock
from repro_torch.models.api import build_model, resolve_device
from repro_torch.pipeline.cascade import LMCascade, make_escalate
from repro_torch.pipeline.executor import PipelineExecutor
from repro_torch.pipeline.graph import (PipelineGraph, cascade_graph,
                                        fanout_graph)
from repro_torch.serving.engine import LMServer
from repro_torch.workloads import traces as T
from repro_torch.workloads.scenario import (D_FEAT, N_CLASSES, SCENARIOS,
                                            Scenario, lm_config,
                                            sampled_replay, seeded_params,
                                            trace_meta)

# cascade gate: 2 draft models agree (confidence 1.0) or split (0.5);
# anything below this escalates, so the threshold means "escalate on any
# draft disagreement"
CASCADE_THRESHOLD = 0.75

# cost shape of the zoo relative to Scenario.base_latency — the accurate
# model is an order of magnitude hotter than a draft member, and its
# per-item cost actually binds under batching (so a monolithic deployment
# saturates where the cascade still has headroom)
COSTS: Dict[str, Tuple[float, float]] = {
    # model -> (base multiplier, per-item multiplier) on the scenario's
    # (base_latency, per_item_latency)
    "prep": (0.25, 0.5),
    "cheap0": (1.0, 1.0),
    "cheap1": (1.0, 1.0),
    "accurate": (4.0, 30.0),
}

# draft scorers see the truth through this much weight noise; accurate sees
# almost none — tuned so drafts disagree on ~10-20% of queries
DRAFT_NOISE = 0.15
ACCURATE_NOISE = 0.05


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def _scorer(W: np.ndarray) -> Callable:
    def predict(x: np.ndarray) -> np.ndarray:
        return _softmax(x @ W)
    return predict


def pipeline_models(scenario: Scenario):
    """(models, latency_models, service_priors, label_fn) for a scenario.

    ``label_fn`` maps raw features to the hidden true class — benchmarks
    use it to score cascade vs monolithic accuracy."""
    rng = np.random.default_rng([scenario.seed, 31337])
    W_true = rng.normal(size=(D_FEAT, N_CLASSES)).astype(np.float32) * 0.2

    def prep(x: np.ndarray) -> np.ndarray:
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return (x / np.maximum(n, 1e-6)) * np.sqrt(x.shape[-1])

    models: Dict[str, Callable] = {"prep": prep}
    noises = {"cheap0": DRAFT_NOISE, "cheap1": DRAFT_NOISE,
              "accurate": ACCURATE_NOISE}
    for mid, noise in noises.items():
        Wm = W_true + noise * rng.normal(
            size=W_true.shape).astype(np.float32) * 0.2
        models[mid] = _scorer(Wm)

    lat: Dict[str, Any] = {}
    priors: Dict[str, float] = {}
    for i, mid in enumerate(sorted(COSTS)):
        base_m, item_m = COSTS[mid]
        lat[mid] = linear_latency(
            scenario.base_latency * base_m,
            scenario.per_item_latency * item_m,
            p_straggle=scenario.p_straggle,
            straggle_factor=scenario.straggle_factor,
            rng=np.random.default_rng([scenario.seed, 5000 + i]))
        priors[mid] = (scenario.base_latency * base_m
                       + scenario.per_item_latency * item_m)

    def label_fn(x: np.ndarray) -> np.ndarray:
        return np.argmax(prep(x) @ W_true, axis=-1)

    return models, lat, priors, label_fn


def pipeline_replica_factory(scenario: Scenario, models: Dict[str, Callable]):
    """Deterministic fresh-replica supplier for per-stage autoscaling:
    replica k of model ``mid`` draws its latency stream from seed
    (scenario.seed, model index, k) — the ``cluster.plan.replica_factory``
    contract for the pipeline zoo."""
    ids = sorted(COSTS)
    counters: Dict[str, int] = {}

    def make(mid: str) -> TorchModelContainer:
        k = counters.get(mid, 0)
        counters[mid] = k + 1
        i = ids.index(mid)
        base_m, item_m = COSTS[mid]
        latm = linear_latency(
            scenario.base_latency * base_m,
            scenario.per_item_latency * item_m,
            p_straggle=scenario.p_straggle,
            straggle_factor=scenario.straggle_factor,
            rng=np.random.default_rng([scenario.seed, 8000 + i, k]))
        return TorchModelContainer(mid, models[mid], latency_model=latm)

    return make


# ---------------------------------------------------------------------------
# named pipeline presets
# ---------------------------------------------------------------------------

def build_graph(kind: str, *, threshold: float = CASCADE_THRESHOLD
                ) -> PipelineGraph:
    if kind == "cascade":
        return cascade_graph(("cheap0", "cheap1"), "accurate",
                             preprocess_model="prep", threshold=threshold)
    if kind == "fanout":
        return fanout_graph(("cheap0", "cheap1", "accurate"),
                            preprocess_model="prep")
    raise KeyError(f"unknown pipeline graph {kind!r}; "
                   f"have ['cascade', 'fanout']")


def build_executor(scenario: Scenario, kind: str = "cascade", *,
                   threshold: float = CASCADE_THRESHOLD,
                   admission=None, router=None, use_cache: bool = True,
                   zoo=None, tracer=None, audit=None,
                   device="cuda") -> PipelineExecutor:
    """``zoo``: a prebuilt ``pipeline_models(scenario)`` tuple, so callers
    that also need the models (replica factories) construct them once.
    ``device``: where the Exp4 selection state lives."""
    models, lat, priors, _ = zoo if zoo is not None else \
        pipeline_models(scenario)
    return PipelineExecutor(
        build_graph(kind, threshold=threshold), models,
        slo=scenario.slo, latency_models=lat, replicas=scenario.replicas,
        batch_delay=scenario.batch_delay, seed=scenario.seed,
        service_priors=priors, admission=admission, router=router,
        use_cache=use_cache, tracer=tracer, audit=audit, device=device)


def run_pipeline(scenario: Scenario, kind: str = "cascade", *,
                 threshold: float = CASCADE_THRESHOLD,
                 use_cache: bool = True, tracer=None, sampler=None,
                 audit=None, device="cuda") -> Dict[str, Any]:
    """Replay the scenario's trace through a pipeline and report — the
    pipeline counterpart of ``ScenarioRunner.run`` (byte-identical JSON per
    seed). ``sampler`` / ``audit``: optional repro_torch.obs collectors.
    ``device``: where the Exp4 selection state lives (raises without a
    card unless ``"cpu"``)."""
    ex = build_executor(scenario, kind, threshold=threshold,
                        use_cache=use_cache, tracer=tracer, audit=audit,
                        device=device)
    trace = T.query_trace(scenario.arrival_times(), scenario.seed,
                          d_feat=D_FEAT, pool=scenario.pool)
    if sampler is not None:
        sampler.bind(metrics=ex.metrics, tracer=tracer)
        sampler.add_probe(ex.timeseries_probe)
        sampled_replay(ex.clip,
                       lambda x, ctx, at: ex.submit(x, arrival_time=at),
                       trace, sampler)
    else:
        ex.replay(trace)
    rep = ex.report()
    rep["scenario"] = dataclasses.asdict(scenario)
    rep["meta"] = trace_meta(scenario)
    return rep


def build_lmcascade(scenario: Scenario, *, threshold: float = 0.9,
                    draft_admission=None, verify_admission=None,
                    tracer=None, audit=None, device="cuda", cfg=None):
    """Construct the two-tier LM cascade for this scenario. Returns
    ``(cascade, clock, params, pending)``, ``pending`` the arrival list
    ``[(time, prompt)]``, as ``ScenarioRunner.build_lmserver`` does; both
    tiers serve one model and one params tree. ``cfg``: the served model
    (default :func:`~repro_torch.workloads.scenario.lm_config`, as for the
    lmserver stack). The weights are drawn on the CPU from a generator
    seeded with the scenario's seed and then moved to ``device``, so a card
    run and a CPU run serve the same weights."""
    s = scenario
    dev = resolve_device(device)
    cfg = lm_config() if cfg is None else cfg
    params = seeded_params(cfg, s.seed, dev)
    model = build_model(cfg, device=dev)

    def service_model(scale: float):
        def sm(kind: str, batch: int, tokens: int) -> float:
            if kind == "prefill":
                return scale * (s.base_latency
                                + s.per_item_latency * batch * tokens)
            return scale * (s.base_latency / 4 + s.per_item_latency * batch)
        return sm

    clock = VirtualClock()
    # one tracer spans both tiers: a draft request and its escalated verify
    # re-decode appear as two traces on one shared timeline
    draft = LMServer(model, device=dev, slots=s.slots, max_len=64,
                     slo=s.slo, temperature=0.0, seed=s.seed, clock=clock,
                     service_model=service_model(1.0), model_id="draft",
                     metrics=MetricsRegistry(s.slo),
                     admission_control=draft_admission, tracer=tracer,
                     audit=audit)
    verify = LMServer(model, device=dev, slots=s.slots, max_len=64,
                      slo=s.slo, temperature=0.0, seed=s.seed + 1,
                      clock=clock, service_model=service_model(4.0),
                      model_id="verify", metrics=MetricsRegistry(s.slo),
                      admission_control=verify_admission, tracer=tracer,
                      audit=audit)
    casc = LMCascade(draft, verify, escalate=make_escalate(threshold),
                     slo=s.slo)
    rng = np.random.default_rng(s.seed)
    times = s.arrival_times()[:s.lm_requests]
    if len(times) == 0:
        times = np.asarray([0.0])
    pending = [(float(t), rng.integers(0, cfg.vocab_size, size=s.prompt_len))
               for t in times]
    return casc, clock, params, pending


def drive_lmcascade(scenario: Scenario, casc: LMCascade, clock, params,
                    pending, *, sampler=None) -> Dict[str, Any]:
    """Replay ``pending`` through the cascade on the virtual clock, both
    tiers on ``params``; returns the cascade's report."""
    s = scenario
    if sampler is not None:
        # burn-rate monitoring tracks the draft tier (every request enters
        # there); both tiers' fleet series are sampled
        sampler.bind(metrics=casc.draft.metrics, tracer=casc.draft.tracer)
        sampler.add_probe(casc.draft.timeseries_probe)
        sampler.add_probe(casc.verify.timeseries_probe)
    i = 0
    while i < len(pending) or casc.pending:
        while i < len(pending) and pending[i][0] <= clock.now:
            at, prompt = pending[i]
            casc.submit(prompt, max_new_tokens=s.max_new_tokens, now=at)
            i += 1
        if not casc.pending and i < len(pending):
            clock.advance(pending[i][0] - clock.now)
            if sampler is not None:
                sampler.sample_until(clock.now)
            continue
        casc.step(params, params)
        if sampler is not None:
            sampler.sample_until(clock.now)
    rep = casc.report()
    rep["scenario"] = dataclasses.asdict(s)
    rep["meta"] = trace_meta(s)
    return rep


def run_lmcascade(scenario: Scenario, *, threshold: float = 0.9,
                  draft_admission=None, verify_admission=None,
                  tracer=None, sampler=None, audit=None,
                  device="cuda") -> Dict[str, Any]:
    """Draft-then-verify across two calibrated-simulation LM engines: the
    draft engine decodes every prompt with a cheap service model; drafts
    that fail the distinct-token confidence check re-decode on the verify
    engine (4x the service cost). Deterministic per seed. ``device``:
    where the LM lives (raises without a card unless ``"cpu"``)."""
    casc, clock, params, pending = build_lmcascade(
        scenario, threshold=threshold, draft_admission=draft_admission,
        verify_admission=verify_admission, tracer=tracer, audit=audit,
        device=device)
    return drive_lmcascade(scenario, casc, clock, params, pending,
                           sampler=sampler)


def pipeline_scenario(name: str = "pipeline", **overrides: Any) -> Scenario:
    """Look up a named workload scenario (default: the pipeline regime
    registered in ``workloads.scenario.SCENARIOS``) with overrides."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return dataclasses.replace(SCENARIOS[name], **overrides)
