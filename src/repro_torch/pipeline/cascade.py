"""LM cascade serving: draft-then-verify between two LMServer engines
(DESIGN.md §12). Counterpart of ``repro.pipeline.cascade`` (a copy, over
the port's ``LMServer``).

The cascade analogue of the frontend pipeline for the continuous-batching
stack: every prompt decodes on a cheap *draft* engine; the engine's
``on_finish`` hook hands the finished request to the cascade, which either
accepts the draft answer or escalates the prompt to an expensive *verify*
engine. End-to-end latency and SLO attainment are accounted once per
request in the cascade's own ``repro.metrics/v1`` registry; each engine
keeps its private registry so per-engine service stats stay separable.

The escalation predicate is pluggable. The default is a deterministic
output-quality proxy — the distinct-token ratio of the draft generation
(degenerate repetition reads as low confidence) — chosen because it is a
pure function of the tokens, so calibrated-simulation runs stay
byte-identical. Production deployments would plug in a logprob margin.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core import metrics as M
from repro_torch.core.metrics import MetricsRegistry
from repro_torch.serving.engine import LMServer, Request

# escalate(request) -> True to re-run the prompt on the verify engine
EscalateFn = Callable[[Request], bool]


def distinct_token_confidence(tokens: Sequence[int]) -> float:
    """Distinct-token ratio of a generation — 1.0 for all-unique output,
    approaching 0 for degenerate repetition."""
    if not tokens:
        return 0.0
    return len(set(int(t) for t in tokens)) / len(tokens)


def make_escalate(threshold: float) -> EscalateFn:
    """Escalate drafts whose distinct-token confidence is below
    ``threshold`` (0.0 never escalates; anything > 1.0 always does)."""

    def escalate(r: Request) -> bool:
        return distinct_token_confidence(r.tokens) < threshold

    return escalate


class LMCascade:
    """Two-engine cascade over a shared (virtual or wall) clock.

    ``draft`` and ``verify`` must share the same clock; give each its own
    ``MetricsRegistry`` — the cascade owns the end-to-end registry."""

    def __init__(self, draft: LMServer, verify: LMServer, *,
                 escalate: Optional[EscalateFn] = None,
                 slo: float = 0.5,
                 metrics: Optional[MetricsRegistry] = None):
        if draft.clock is not verify.clock:
            raise ValueError("draft and verify engines must share one clock")
        if draft.metrics is verify.metrics:
            raise ValueError(
                "give each engine its own registry; the cascade accounts "
                "end-to-end metrics itself")
        self.draft = draft
        self.verify = verify
        self.escalate = escalate if escalate is not None else make_escalate(0.9)
        self.slo = slo
        self.metrics = metrics if metrics is not None else MetricsRegistry(slo)
        self.results: Dict[int, Dict[str, Any]] = {}
        self.shed_cids: set = set()
        self.escalated = 0
        self._next_id = 0
        self._draft_rid_to_cid: Dict[int, int] = {}
        self._verify_rid_to_cid: Dict[int, int] = {}
        self._meta: Dict[int, Dict[str, Any]] = {}   # cid -> bookkeeping
        draft.on_finish = self._on_draft_finish
        verify.on_finish = self._on_verify_finish

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               now: Optional[float] = None) -> int:
        """Enqueue a prompt on the draft tier; returns the cascade id."""
        cid = self._next_id
        self._next_id += 1
        at = self.draft.clock() if now is None else now
        self.metrics.inc(M.QUERIES_SUBMITTED)
        self.metrics.mark(at)
        self._meta[cid] = {"prompt": np.asarray(prompt, np.int32),
                           "max_new_tokens": max_new_tokens, "arrival": at}
        shed0 = self.draft.shed
        rid = self.draft.submit(prompt, max_new_tokens=max_new_tokens,
                                now=at)
        if self.draft.shed > shed0:
            # the draft engine's admission control shed it: such a request
            # never fires on_finish, so account the cascade-level shed here
            del self._meta[cid]
            self.shed_cids.add(cid)
            self.metrics.inc(M.QUERIES_SHED)
            return cid
        self._draft_rid_to_cid[rid] = cid
        return cid

    def _on_draft_finish(self, r: Request) -> None:
        cid = self._draft_rid_to_cid.pop(r.request_id, None)
        if cid is None:
            return
        meta = self._meta[cid]
        # an injected draft failure (repro_torch.faults.RequestFaults)
        # forces escalation: the draft answer is unusable, so the verify
        # tier is the retry path (counted under faults.retries)
        failed = bool(getattr(r, "failed", False))
        if failed or self.escalate(r):
            self.escalated += 1
            self.metrics.inc(M.PIPELINE_ESCALATIONS)
            if failed:
                self.metrics.inc_both(M.FAULTS_RETRIES,
                                      model=self.draft.model_id)
            now = self.draft.clock()
            shed0 = self.verify.shed
            rid = self.verify.submit(meta["prompt"],
                                     max_new_tokens=meta["max_new_tokens"],
                                     now=now)
            if self.verify.shed > shed0:
                # verify tier refused: degrade to the draft answer instead
                # of losing the request (shed requests never fire on_finish)
                self.metrics.inc(M.QUERIES_DEGRADED)
                self._complete(cid, r, tier="draft")
                return
            self._verify_rid_to_cid[rid] = cid
            # keep the draft answer: if the verify pass itself fails we
            # degrade to it rather than losing the request
            meta["draft"] = r
            return
        self.metrics.inc(M.PIPELINE_STAGES_SKIPPED)
        self._complete(cid, r, tier="draft")

    def _on_verify_finish(self, r: Request) -> None:
        cid = self._verify_rid_to_cid.pop(r.request_id, None)
        if cid is None:
            return
        draft = self._meta[cid].get("draft")
        if getattr(r, "failed", False) and draft is not None \
                and not getattr(draft, "failed", False):
            # graceful degradation (DESIGN.md §14): a failed verify pass
            # falls back to the draft answer it was double-checking
            self.metrics.inc(M.QUERIES_DEGRADED)
            self._complete(cid, draft, tier="draft", finish=r.finish_time)
            return
        self._complete(cid, r, tier="verify")

    def _complete(self, cid: int, r: Request, *, tier: str,
                  finish: Optional[float] = None) -> None:
        meta = self._meta.pop(cid)
        if finish is None:
            finish = (r.finish_time if r.finish_time is not None
                      else self.draft.clock())
        latency = finish - meta["arrival"]
        self.metrics.inc(M.QUERIES_COMPLETED)
        self.metrics.observe_latency(latency)
        self.metrics.mark(finish)
        self.results[cid] = {"tokens": list(r.tokens), "tier": tier,
                             "latency": latency}

    # ------------------------------------------------------------------
    @property
    def pending(self) -> bool:
        return self.draft.pending or self.verify.pending

    def step(self, draft_params, verify_params) -> None:
        """Advance both tiers one engine step each (draft first — its
        completions may enqueue verify work that the verify step can then
        admit in the same cascade step)."""
        if self.draft.pending:
            self.draft.step(draft_params)
        if self.verify.pending:
            self.verify.step(verify_params)

    def run(self, draft_params, verify_params, *,
            max_steps: int = 100_000) -> None:
        steps = 0
        while self.pending and steps < max_steps:
            self.step(draft_params, verify_params)
            steps += 1

    # ------------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """End-to-end report plus a ``cascade`` section with per-tier engine
        stats (each tier's private registry, rendered with the same schema)."""
        rep = self.metrics.report("lmcascade")
        completed = self.metrics.counter(M.QUERIES_COMPLETED)
        rep["cascade"] = {
            "escalated": self.escalated,
            "escalation_rate": (self.escalated / completed) if completed
                               else 0.0,
            "draft": self.draft.report(),
            "verify": self.verify.report(),
        }
        return rep

    def report_json(self, **extra: Any) -> str:
        import json
        rep = self.report()
        rep.update(extra)
        return json.dumps(rep, sort_keys=True, indent=2)
