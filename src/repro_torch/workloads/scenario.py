"""ScenarioRunner, counterpart of ``repro.workloads.scenario``: replay a
generated arrival trace through either serving stack and emit the shared
``repro.metrics/v1`` report.

The named scenarios map to the paper's evaluation (DESIGN.md §9):

* ``poisson``      — steady open-loop load, Fig 4's latency/throughput regime
* ``bursty``       — MMPP burst/lull load, Fig 5's delayed-batching regime
* ``diurnal``      — slow rate ramp (InferLine-style day/night profile)
* ``flash_crowd``  — sudden rate spike: queueing + SLO-violation behaviour
* ``scaling``      — Fig 6: the same load over 1..R replicas
* ``stragglers``   — Fig 9: wide ensemble with injected stragglers; deadline
                     rendering keeps P99 at the SLO while accounting the
                     dropped models

Both stacks run in calibrated-simulation mode (DESIGN.md §8): service times
come from seeded latency models and the clock is virtual, so a scenario is a
pure function of its seed — run it twice, get byte-identical reports, and
the same report as the reference's.

The runner takes a ``device`` (the card unless the caller asks for the
CPU). The frontend stack's models are numpy by the scenario's definition
(``frontend_models``), so on that stack the device holds only the selection
state; the lmserver stack serves its LM there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.registry import ARCHITECTURES, reduced_config
from repro_torch.core.containers import linear_latency
from repro_torch.core.frontend import make_clipper
from repro_torch.core.metrics import VirtualClock
from repro_torch.models.api import build_model, resolve_device
from repro_torch.serving.engine import LMServer
from repro_torch.workloads import traces as T

D_FEAT = 64
N_CLASSES = 10


@dataclass(frozen=True)
class Scenario:
    """A reproducible load profile plus the serving configuration it drives."""

    name: str
    kind: str = "poisson"           # poisson | bursty | diurnal | flash_crowd
    rate: float = 400.0             # mean arrival rate (qps)
    peak_rate: float = 1200.0       # bursty/diurnal/flash peak (qps)
    duration: float = 2.0           # trace length (s)
    seed: int = 0
    slo: float = 0.020
    # frontend (Clipper) stack
    ensemble: int = 2               # models in the ensemble
    replicas: int = 1               # replicas per model (Fig 6)
    batch_delay: float = 0.0
    pool: int = 128                 # unique-query pool (0 = all unique)
    p_straggle: float = 0.0         # straggler injection (Fig 9)
    straggle_factor: float = 15.0
    base_latency: float = 0.002     # container latency model: base + per_item*n
    per_item_latency: float = 5e-5
    # lmserver stack
    slots: int = 4
    prompt_len: int = 8
    max_new_tokens: int = 4
    lm_requests: int = 32           # lmserver replays a fixed request count

    def arrival_times(self) -> np.ndarray:
        if self.kind == "poisson":
            return T.poisson_trace(self.rate, self.duration, self.seed)
        if self.kind == "bursty":
            return T.bursty_trace(self.rate, self.peak_rate, self.duration,
                                  self.seed)
        if self.kind == "diurnal":
            return T.diurnal_trace(self.rate, self.peak_rate, self.duration,
                                   self.seed)
        if self.kind == "flash_crowd":
            return T.flash_crowd_trace(self.rate, self.peak_rate,
                                       self.duration, self.seed)
        raise ValueError(f"unknown trace kind: {self.kind}")


SCENARIOS: Dict[str, Scenario] = {
    "poisson": Scenario("poisson"),
    "bursty": Scenario("bursty", kind="bursty", rate=150.0, peak_rate=1500.0),
    "diurnal": Scenario("diurnal", kind="diurnal", rate=100.0,
                        peak_rate=900.0, duration=4.0),
    "flash_crowd": Scenario("flash_crowd", kind="flash_crowd", rate=200.0,
                            peak_rate=2500.0),
    "scaling": Scenario("scaling", rate=900.0, replicas=4,
                        base_latency=0.004, pool=0),
    "stragglers": Scenario("stragglers", rate=250.0, ensemble=4,
                           p_straggle=0.03, pool=0),
    # the prediction-pipeline regime (repro.pipeline, DESIGN.md §12): load
    # near the *accurate* model's saturation point so a cascade matters, a
    # Zipf query pool so the intermediate cache matters
    "pipeline": Scenario("pipeline", rate=300.0, duration=2.0, pool=256,
                         base_latency=0.001, per_item_latency=1e-4,
                         max_new_tokens=8),
}


def trace_meta(scenario: Scenario) -> Dict[str, Any]:
    """Provenance block for the ``repro.metrics/v1`` report: the trace seed
    and generator that produced the run, so an archived report is
    reproducible without the invoking command line."""
    return {
        "trace_seed": scenario.seed,
        "trace_generator": f"{scenario.kind}_trace",
    }


def frontend_models(scenario: Scenario):
    """Deterministic numpy ensemble of graded quality + latency profiles.
    Model i is a fixed linear scorer; its latency model is seeded from
    (scenario.seed, i) so the whole run is a function of the scenario."""
    rng = np.random.default_rng(scenario.seed + 1)
    models, lat = {}, {}
    for i in range(scenario.ensemble):
        W = rng.normal(size=(D_FEAT, N_CLASSES)).astype(np.float32) * 0.1

        def predict(x, W=W):
            z = x @ W
            z = z - z.max(axis=-1, keepdims=True)
            e = np.exp(z)
            return e / e.sum(axis=-1, keepdims=True)

        mid = f"m{i}"
        models[mid] = predict
        lat[mid] = linear_latency(
            scenario.base_latency * (1.0 + 0.3 * i),
            scenario.per_item_latency,
            p_straggle=scenario.p_straggle,
            straggle_factor=scenario.straggle_factor,
            rng=np.random.default_rng(scenario.seed + 1000 + i))
    return models, lat


def sampled_replay(serve, submit, trace, sampler) -> None:
    """Open-loop replay with fleet sampling: the ``replay`` contract, but
    the clock also steps through every sample boundary, so the sampler
    observes the run at its fixed interval even across idle gaps.
    ``serve`` needs ``run`` / ``now`` (settable) / ``pending``;
    ``submit(x, ctx, at)`` issues one query."""
    t = 0.0
    for at, x, ctx in trace:
        while t + sampler.interval <= at:
            t += sampler.interval
            serve.run(until=t)
            if serve.now < t:
                # idle gap: advance the virtual clock so delayed batches
                # see time passing, then dispatch what became ready
                serve.now = t
                serve.run(until=t)
            sampler.sample_until(t)
        serve.run(until=at)
        submit(x, ctx, at)
    while serve.pending:
        t += sampler.interval
        serve.run(until=t)
        if serve.now < t:
            serve.now = t
            serve.run(until=t)
        sampler.sample_until(t)


def lm_config():
    """The LM the lmserver stack and the LM cascade serve: smollm-360m,
    reduced as the reference reduces it (2 layers, d_model 64, head_dim
    16)."""
    return reduced_config(ARCHITECTURES["smollm-360m"], num_layers=2,
                          d_model=64)


class ScenarioRunner:
    """Replays one scenario through a serving stack; ``run`` returns the
    shared-schema report dict, ``run_json`` its stable JSON rendering."""

    def __init__(self, scenario: Scenario, *, tracer=None, sampler=None,
                 audit=None, device="cuda"):
        """``tracer``: an optional ``repro_torch.obs.Tracer`` threaded into
        whichever stack runs — span logs are byte-identical per seed, like
        the reports. ``sampler`` / ``audit``: optional repro_torch.obs
        ``FleetSampler`` / ``AuditLog``, attached the same way. ``device``:
        where the selection state and the LM live (raises without a card
        unless ``"cpu"``)."""
        self.scenario = scenario
        self.tracer = tracer
        self.sampler = sampler
        self.audit = audit
        self.device = resolve_device(device)

    # -- frontend (discrete-event Clipper) ------------------------------
    def run_frontend(self) -> Dict[str, Any]:
        s = self.scenario
        models, lat = frontend_models(s)
        clip = make_clipper(models, "exp4", slo=s.slo,
                            replicas=s.replicas, latency_models=lat,
                            batch_delay=s.batch_delay, seed=s.seed,
                            tracer=self.tracer, audit=self.audit,
                            device=self.device)
        trace = T.query_trace(s.arrival_times(), s.seed, d_feat=D_FEAT,
                              pool=s.pool)
        if self.sampler is not None:
            self.sampler.bind(metrics=clip.metrics, tracer=self.tracer)
            self.sampler.add_probe(clip.timeseries_probe)
            sampled_replay(clip, lambda x, ctx, at: clip.submit(
                x, context_id=ctx, arrival_time=at), trace, self.sampler)
        else:
            clip.replay(trace)
        return clip.report()

    # -- lmserver (continuous batching) ---------------------------------
    def build_lmserver(self, *, admission=None, cfg=None):
        """Construct the calibrated-simulation LMServer for this scenario.
        Returns ``(srv, clock, params, pending)`` where ``pending`` is the
        arrival list ``[(time, prompt)]`` — the control-plane driver reuses
        this to run the same stack with admission control in front.
        ``cfg``: the served model (default :func:`lm_config`). The
        weights are drawn on the CPU from a generator seeded with the
        scenario's seed and then moved to the runner's device, so a card
        run and a CPU run serve the same weights."""
        s = self.scenario
        cfg = lm_config() if cfg is None else cfg
        params = seeded_params(cfg, s.seed, self.device)
        model = build_model(cfg, device=self.device)

        def service_model(kind: str, batch: int, tokens: int) -> float:
            if kind == "prefill":
                return s.base_latency + s.per_item_latency * batch * tokens
            return s.base_latency / 4 + s.per_item_latency * batch

        clock = VirtualClock()
        srv = LMServer(model, device=self.device, slots=s.slots, max_len=64,
                       slo=s.slo, temperature=0.0, seed=s.seed,
                       clock=clock, service_model=service_model,
                       model_id=cfg.name, admission_control=admission,
                       tracer=self.tracer, audit=self.audit)
        rng = np.random.default_rng(s.seed)
        # open-loop arrivals, thinned to a fixed request count so CLI runs
        # stay cheap; the arrival *process* is the scenario's
        times = self.scenario.arrival_times()[:s.lm_requests]
        if len(times) == 0:
            times = np.asarray([0.0])
        pending: List[Tuple[float, np.ndarray]] = [
            (float(t), rng.integers(0, cfg.vocab_size, size=s.prompt_len))
            for t in times]
        return srv, clock, params, pending

    def run_lmserver(self, *, admission=None) -> Dict[str, Any]:
        """Calibrated simulation: a tiny real model decodes for real, but
        service times come from a seeded latency model through a virtual
        clock — deterministic end to end."""
        return self.drive_lmserver(*self.build_lmserver(admission=admission))

    def drive_lmserver(self, srv, clock, params, pending) -> Dict[str, Any]:
        """Replay ``pending`` through ``srv`` on the virtual clock; returns
        the server's report."""
        s = self.scenario
        if self.sampler is not None:
            self.sampler.bind(metrics=srv.metrics, tracer=self.tracer)
            self.sampler.add_probe(srv.timeseries_probe)
        i = 0
        while i < len(pending) or srv.pending:
            # release arrivals up to the virtual now
            while i < len(pending) and pending[i][0] <= clock.now:
                at, prompt = pending[i]
                srv.submit(prompt, max_new_tokens=s.max_new_tokens, now=at)
                i += 1
            if not srv.pending and i < len(pending):
                clock.advance(pending[i][0] - clock.now)   # idle: jump ahead
                if self.sampler is not None:
                    self.sampler.sample_until(clock.now)
                continue
            srv.step(params)
            if self.sampler is not None:
                self.sampler.sample_until(clock.now)
        return srv.report()

    # -- entry points ---------------------------------------------------
    def run(self, stack: str = "frontend") -> Dict[str, Any]:
        if stack == "frontend":
            rep = self.run_frontend()
        elif stack == "lmserver":
            rep = self.run_lmserver()
        else:
            raise ValueError(f"unknown stack: {stack}")
        rep["scenario"] = dataclasses.asdict(self.scenario)
        rep["meta"] = trace_meta(self.scenario)
        return rep

    def run_json(self, stack: str = "frontend") -> str:
        import json
        return json.dumps(self.run(stack), sort_keys=True, indent=2)


def run_scenario(name: str, stack: str = "frontend", *, tracer=None,
                 sampler=None, audit=None, device="cuda",
                 **overrides: Any) -> Dict[str, Any]:
    """Convenience: look up a named scenario, apply overrides, run it."""
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    sc = dataclasses.replace(SCENARIOS[name], **overrides)
    return ScenarioRunner(sc, tracer=tracer, sampler=sampler,
                          audit=audit, device=device).run(stack)


def seeded_params(cfg, seed: int, device):
    """``cfg``'s weights drawn on the CPU from a generator seeded with
    ``seed``, then moved to ``device``: a card run and a CPU run serve the
    same weights."""
    host = build_model(cfg, device="cpu")
    return _to(host.init(torch.Generator().manual_seed(seed)), device)


def _to(tree, device):
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
