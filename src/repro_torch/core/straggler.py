"""Straggler mitigation (paper §5.2.2).

Counterpart of ``repro.core.straggler``. Design choice from the paper: a
*late* prediction is worse than an *inaccurate* one. At the query's latency
deadline the combine function is invoked with the subset of predictions that
arrived; missing models are mean-substituted and the confidence score
communicates the loss of ensemble width. The masked math lives here (tensor
functions); the deadline scheduling lives in the serving engine and
frontend."""

from __future__ import annotations

import functools
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.models.api import resolve_device


def assemble_preds(model_ids: Sequence[str], preds: Dict[str, Any], *,
                   device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack per-model predictions into [k, ...], mean-substituting missing
    models (paper: 'we substitute missing predictions with their average
    value'). Returns (matrix, available mask) on ``device``."""
    dev = resolve_device(device)
    available = np.asarray([m in preds for m in model_ids])
    if not available.any():
        raise ValueError("no predictions available at deadline")
    vals = [np.asarray(preds[m], dtype=np.float32)
            for m in model_ids if m in preds]
    mean = np.mean(vals, axis=0)
    rows = [np.asarray(preds[m], np.float32) if m in preds else mean
            for m in model_ids]
    return (torch.from_numpy(np.stack(rows)).to(dev),
            torch.from_numpy(available).to(dev))


def render_without(model_ids: Sequence[str], preds: Dict[str, Any],
                   without: Sequence[str]) -> np.ndarray:
    """The ensemble answer rendered as if ``without`` models never replied —
    the degraded output a query falls back to when a model's replicas have
    failed past their retry budget (DESIGN.md §14). Pure function of the
    surviving predictions: averaging only the available rows (the masked
    mean ``assemble_preds`` callers compute), so repeated renders from the
    same survivors are deterministic. Host math: the answer goes back to
    the caller as numpy."""
    kept = {m: p for m, p in preds.items() if m not in set(without)}
    mat, avail = assemble_preds(model_ids, kept, device="cpu")
    mask = avail.reshape((-1,) + (1,) * (mat.dim() - 1))
    # the rows summed one after another, in model order, as the reference's
    # reduction adds them (``sum(dim=0)`` pairs them otherwise from k = 5)
    rows = torch.where(mask, mat, 0.0).unbind(0)
    y = functools.reduce(torch.add, rows) / torch.clamp_min(avail.sum(), 1)
    return y.numpy()


def agreement_confidence(preds_matrix: torch.Tensor,
                         available: torch.Tensor) -> float:
    """Fraction of available models that agree with the plurality vote."""
    votes = torch.argmax(preds_matrix, dim=-1)
    combined = torch.argmax(
        torch.mean(torch.where(available[:, None], preds_matrix, 0.0), dim=0))
    agree = (votes == combined) & available
    return float(agree.sum() / torch.clamp_min(available.sum(), 1))


def record_stragglers(metrics, missing_models: Sequence[str]) -> None:
    """Single accounting convention for straggler mitigation, shared by both
    serving stacks: one ``straggler.partial_queries`` per degraded query,
    ``straggler.dropped_models`` per missing ensemble member."""
    if metrics is None or not missing_models:
        return
    metrics.inc(M.STRAGGLER_PARTIAL)
    metrics.inc(M.STRAGGLER_DROPPED, len(missing_models))


class DeadlineTracker:
    """Book-keeping for per-query deadlines in the serving loop."""

    def __init__(self, slo: float):
        self.slo = slo

    def deadline_for(self, arrival_time: float) -> float:
        return arrival_time + self.slo

    def expired(self, arrival_time: float, now: float) -> bool:
        return now >= self.deadline_for(arrival_time)

    def remaining(self, arrival_time: float, now: float) -> float:
        return max(0.0, self.deadline_for(arrival_time) - now)
