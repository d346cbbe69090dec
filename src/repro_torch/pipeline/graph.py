"""Pipeline graph spec (DESIGN.md §12); counterpart of
``repro.pipeline.graph`` (a copy). The canonical combines are host math on
one query's numpy predictions, as the frontend's per-query combine is: they
assemble the stage's predictions on the CPU (``assemble_preds(...,
device="cpu")``), where the stage's outputs are consumed.

A ``PipelineGraph`` composes model containers into a DAG of *stages*. Each
stage evaluates zero or more models on one prepared input (fan-out *within*
a stage is an ensemble evaluated in parallel) and reduces the results with a
``combine`` function; edges between stages carry combined outputs (fan-in).
A stage with an optional ``gate`` predicate runs conditionally on its
parents' outputs — the cascade pattern, where a cheap draft stage answers
and only low-confidence queries escalate to an accurate verify stage
(confidence = ``agreement_confidence`` over the draft ensemble, reused from
``core/straggler.py``).

The spec is pure data + pure functions; execution (queues, deadlines,
caching, straggler mitigation) lives in ``pipeline/executor.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.straggler import agreement_confidence, assemble_preds

# combine(stage_input, preds, parent_outputs) -> stage output
CombineFn = Callable[[Any, Dict[str, Any], Dict[str, Any]], Any]
# prepare(query_x, parent_outputs) -> model input for this stage
PrepareFn = Callable[[Any, Dict[str, Any]], Any]
# gate(parent_outputs) -> True to run the stage, False to skip it
GateFn = Callable[[Dict[str, Any]], bool]


@dataclass(frozen=True)
class Stage:
    """One node of the pipeline DAG.

    ``model_ids`` fan out within the stage (evaluated in parallel, combined
    by ``combine``); an empty tuple makes a pure fan-in/combine node that
    costs nothing and never touches a queue. ``prepare`` builds the model
    input from the query and the parents' outputs; the default passes the
    sole parent's output through when it is an ndarray (feature-transform
    chains) and falls back to the raw query input otherwise (a cascade's
    verify stage re-reads the features, not the draft's structured output).
    """

    name: str
    model_ids: Tuple[str, ...] = ()
    parents: Tuple[str, ...] = ()
    combine: Optional[CombineFn] = None
    prepare: Optional[PrepareFn] = None
    gate: Optional[GateFn] = None

    def prepare_input(self, x: Any, parent_outputs: Dict[str, Any]) -> Any:
        if self.prepare is not None:
            return self.prepare(x, parent_outputs)
        arrays = [v for v in (parent_outputs[p] for p in self.parents)
                  if isinstance(v, np.ndarray)]
        return arrays[0] if len(arrays) == 1 else x

    def combine_preds(self, xin: Any, preds: Dict[str, Any],
                      parent_outputs: Dict[str, Any]) -> Any:
        if self.combine is not None:
            return self.combine(xin, preds, parent_outputs)
        if len(preds) == 1:
            return next(iter(preds.values()))
        vals = [np.asarray(preds[m], np.float32)
                for m in self.model_ids if m in preds]
        return np.mean(vals, axis=0)


class PipelineGraph:
    """Validated DAG of stages with exactly one output stage."""

    def __init__(self, stages: Sequence[Stage], output: Optional[str] = None):
        self.stages: Dict[str, Stage] = {}
        for s in stages:
            if s.name in self.stages:
                raise ValueError(f"duplicate stage name {s.name!r}")
            self.stages[s.name] = s
        for s in self.stages.values():
            for p in s.parents:
                if p not in self.stages:
                    raise ValueError(
                        f"stage {s.name!r} has unknown parent {p!r}")
        self.order = self._topo_order()
        leaves = [n for n in self.stages
                  if not any(n in c.parents for c in self.stages.values())]
        if output is None:
            if len(leaves) != 1:
                raise ValueError(
                    f"graph needs exactly one output stage, found {leaves}")
            output = leaves[0]
        elif output not in self.stages:
            raise ValueError(f"unknown output stage {output!r}")
        self.output = output

    def _topo_order(self) -> List[str]:
        seen: Dict[str, int] = {}       # 0 = visiting, 1 = done

        order: List[str] = []

        def visit(n: str) -> None:
            state = seen.get(n)
            if state == 1:
                return
            if state == 0:
                raise ValueError(f"cycle through stage {n!r}")
            seen[n] = 0
            for p in self.stages[n].parents:
                visit(p)
            seen[n] = 1
            order.append(n)

        for n in sorted(self.stages):
            visit(n)
        return order

    def roots(self) -> List[Stage]:
        return [s for s in (self.stages[n] for n in self.order)
                if not s.parents]

    def children(self, name: str) -> List[Stage]:
        return [self.stages[n] for n in self.order
                if name in self.stages[n].parents]

    def model_ids(self) -> List[str]:
        out: List[str] = []
        for n in self.order:
            for mid in self.stages[n].model_ids:
                if mid not in out:
                    out.append(mid)
        return out

    def describe(self) -> Dict[str, Any]:
        """Report-stable summary (sorted keys, plain types)."""
        return {
            "output": self.output,
            "stages": [{
                "name": n,
                "models": list(self.stages[n].model_ids),
                "parents": list(self.stages[n].parents),
                "gated": self.stages[n].gate is not None,
            } for n in self.order],
        }


# ---------------------------------------------------------------------------
# canonical graph shapes
# ---------------------------------------------------------------------------

def agreement_combine(model_ids: Sequence[str]) -> CombineFn:
    """Ensemble combine that also measures itself: mean prediction plus the
    fraction of arrived models agreeing with the plurality vote
    (``agreement_confidence``, core/straggler.py) — the signal a cascade
    gate consumes."""
    ids = tuple(model_ids)

    def combine(xin, preds, parent_outputs):
        mat, avail = assemble_preds(ids, preds, device="cpu")
        conf = agreement_confidence(mat, avail)
        y = np.asarray(mat)[np.asarray(avail)].mean(axis=0)
        return {"y": y, "confidence": conf}

    return combine


def cascade_graph(draft_models: Sequence[str], verify_model: str, *,
                  preprocess_model: Optional[str] = None,
                  threshold: float = 0.75) -> PipelineGraph:
    """Two-tier cascade: a cheap draft ensemble answers every query; only
    queries whose draft agreement confidence falls below ``threshold``
    escalate to the accurate verify model.

    Shape: [prep ->] draft(ensemble) -> verify(gated) -> output(combine).
    The verify stage re-reads the (preprocessed) features via fan-in from
    the prep stage; the output stage prefers the verify answer when it ran
    and degrades to the draft answer when verify was skipped *or* shed."""
    draft_ids = tuple(draft_models)
    stages: List[Stage] = []
    feature_stage = ()
    if preprocess_model is not None:
        stages.append(Stage("prep", (preprocess_model,)))
        feature_stage = ("prep",)

    stages.append(Stage("draft", draft_ids, parents=feature_stage,
                        combine=agreement_combine(draft_ids)))

    def features(x, outs):
        # raw query input when there is no prep stage — or when prep was
        # shed outright (its output is None)
        p = outs.get("prep")
        return p if p is not None else x

    def gate(outs):
        d = outs["draft"]
        return d is None or d["confidence"] < threshold

    stages.append(Stage("verify", (verify_model,),
                        parents=feature_stage + ("draft",),
                        prepare=features, gate=gate))

    def output_combine(xin, preds, outs):
        v, d = outs.get("verify"), outs.get("draft")
        if v is not None:
            return {"y": np.asarray(v, np.float32), "confidence": 1.0,
                    "escalated": True}
        if d is None:
            return None                 # both tiers shed: no answer
        return {"y": d["y"], "confidence": d["confidence"],
                "escalated": False}

    stages.append(Stage("output", parents=("draft", "verify"),
                        combine=output_combine))
    return PipelineGraph(stages)


def fanout_graph(branch_models: Sequence[str], *,
                 preprocess_model: Optional[str] = None) -> PipelineGraph:
    """Fan-out/fan-in: [prep ->] one stage per branch model, all combined by
    agreement-weighted mean — the 'preprocess -> {fast, accurate} ->
    combine' shape from the paper's model-composition pitch."""
    branch_ids = tuple(branch_models)
    stages: List[Stage] = []
    feature_stage = ()
    if preprocess_model is not None:
        stages.append(Stage("prep", (preprocess_model,)))
        feature_stage = ("prep",)
    for mid in branch_ids:
        stages.append(Stage(f"branch_{mid}", (mid,), parents=feature_stage))

    def output_combine(xin, preds, outs):
        got = {m: outs[f"branch_{m}"] for m in branch_ids
               if outs.get(f"branch_{m}") is not None}
        if not got:
            return None
        mat, avail = assemble_preds(tuple(got), got, device="cpu")
        return {"y": np.asarray(mat).mean(axis=0),
                "confidence": agreement_confidence(mat, avail),
                "escalated": False}

    stages.append(Stage("output",
                        parents=tuple(f"branch_{m}" for m in branch_ids),
                        combine=output_combine))
    return PipelineGraph(stages)
