"""The lmserver stack of the ``poisson`` scenario: the port's
``ScenarioRunner`` on the CPU against the reference's.

The reference's run (its JAX model compiles, the slow part) is made once,
with a tracer, a fleet sampler and an audit log attached. The port runs the
scenario twice: on its own weights (``model.init`` from a CPU generator
seeded with the scenario's seed), and through a subclass that serves the
reference's weights, bridged. Both reports equal the reference's byte for
byte except ``engine.attention_backend`` (the implementation that ran:
``"jnp"`` there, ``"plain"`` here) and the port's ``engine.decode.graph``
and ``engine.prefill.graph`` (false: no CUDA graph on the CPU); so do the span log, time series and
audit documents. On the bridged weights the token streams are the
reference's up to a bf16 near-tie (ROADMAP.md §C)."""

import functools
import json

import jax
import numpy as np
import pytest

from _torch_ties import assert_streams_within_ties, record_logits

from repro.obs import AuditLog as JAuditLog
from repro.obs import BurnRateMonitor as JBurnRateMonitor
from repro.obs import FleetSampler as JFleetSampler
from repro.obs import Tracer as JTracer
from repro.serving import engine as jax_engine
from repro.workloads.scenario import SCENARIOS
from repro.workloads.scenario import ScenarioRunner as JRunner
from repro_torch.bridge import params_from_numpy
from repro_torch.obs import AuditLog, BurnRateMonitor, FleetSampler, Tracer
from repro_torch.serving import engine as torch_engine
from repro_torch.workloads.scenario import ScenarioRunner

SC = SCENARIOS["poisson"]
# the port's tracer without the engine's step spans, which the reference's
# span log has no counterpart of
_PortTracer = functools.partial(Tracer, engine=False)


def _fleet(tracer, sampler, monitor, audit):
    return dict(tracer=tracer(sample_rate=1.0, seed=SC.seed),
                sampler=sampler(interval=0.05, monitor=monitor()),
                audit=audit())


def _documents(rep, fleet):
    return (rep, fleet["tracer"].to_json(), fleet["sampler"].to_json(),
            fleet["audit"].to_json())


class _RecordingJax(JRunner):
    """The reference's runner, keeping its weights and the logits each
    token was sampled from."""

    def __init__(self, mp, **kw):
        super().__init__(SC, **kw)
        self.mp = mp

    def build_lmserver(self, *, admission=None):
        srv, clock, params, pending = super().build_lmserver(
            admission=admission)
        self.srv, self.params = srv, params
        self.logits = record_logits(
            self.mp, srv, jax_engine,
            lambda x, out: jax.debug.callback(
                lambda a: out.append(np.asarray(a).astype(np.float32)), x),
            jax.effects_barrier)
        return srv, clock, params, pending


class _Bridged(ScenarioRunner):
    """The port's runner serving the reference's weights."""

    def __init__(self, mp, jparams, **kw):
        super().__init__(SC, device="cpu", **kw)
        self.mp, self.jparams = mp, jparams

    def build_lmserver(self, *, admission=None):
        srv, clock, _, pending = super().build_lmserver(admission=admission)
        self.srv = srv
        self.logits = record_logits(
            self.mp, srv, torch_engine,
            lambda x, out: out.append(x.float().numpy().copy()),
            lambda: None)
        params = params_from_numpy(jax.tree.map(np.asarray, self.jparams),
                                   device="cpu")
        return srv, clock, params, pending


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        fleet = _fleet(JTracer, JFleetSampler, JBurnRateMonitor, JAuditLog)
        runner = _RecordingJax(mp, **fleet)
        rep = runner.run("lmserver")
        return runner, _documents(rep, fleet)


def _assert_documents_match(want, got):
    """Reports equal but the two named fields; the other documents equal."""
    jrep, trep = json.loads(json.dumps(want[0])), got[0]
    assert jrep["engine"]["attention_backend"] == "jnp"
    assert trep["engine"]["attention_backend"] == "plain"
    assert trep["engine"]["decode"].pop("graph") is False
    assert trep["engine"]["prefill"].pop("graph") is False
    jrep["engine"]["attention_backend"] = "plain"
    assert (json.dumps(trep, sort_keys=True, indent=2)
            == json.dumps(jrep, sort_keys=True, indent=2))
    for w, g, what in zip(want[1:], got[1:], ("spans", "series", "audit")):
        assert g == w, what


def test_lmserver_scenario_matches_reference(reference):
    """The port's own weights: the calibrated report and the fleet
    documents equal the reference's (they do not depend on the tokens:
    fixed lengths, no EOS)."""
    fleet = _fleet(_PortTracer, FleetSampler, BurnRateMonitor, AuditLog)
    rep = ScenarioRunner(SC, device="cpu", **fleet).run("lmserver")
    _assert_documents_match(reference[1], _documents(rep, fleet))
    assert rep["queries"]["completed"] == SC.lm_requests


def test_lmserver_scenario_streams_on_bridged_weights(reference):
    jrunner, want = reference
    with pytest.MonkeyPatch.context() as mp:
        fleet = _fleet(_PortTracer, FleetSampler, BurnRateMonitor, AuditLog)
        runner = _Bridged(mp, jrunner.params, **fleet)
        rep = runner.run("lmserver")
    _assert_documents_match(want, _documents(rep, fleet))
    streams = [{rid: r.tokens for rid, r in srv.completed.items()}
               for srv in (jrunner.srv, runner.srv)]
    assert sorted(streams[0]) == sorted(streams[1])
    assert len(streams[0]) == SC.lm_requests
    assert all(len(t) == SC.max_new_tokens for t in streams[1].values())
    assert_streams_within_ties(streams, (jrunner.logits, runner.logits))
