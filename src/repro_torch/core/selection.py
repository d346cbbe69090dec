"""Model selection layer (paper §5): Exp3 single-model selection and Exp4
ensemble selection, as plain tensor functions on the state's device.

Counterpart of ``repro.core.selection``. States are fp32 log-weight tensors
``[..., k]``: one user's ``[k]`` or the contextual store's ``[n, k]`` rows,
updated eagerly in one batched op each (the reference's ``jax.jit`` and
``vmap``). The order of operations is the reference's: fp32 softmax, the
update, then subtract the logsumexp and clamp at ``LOG_WEIGHT_FLOOR``.

The policies' per-query reads (``Exp3Policy.select``, ``Exp4Policy.combine``)
stay numpy, as in the reference, and read the state with one device-to-host
copy per query; ``host_copies`` counts them."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.api import resolve_device


# ---------------------------------------------------------------------------
# Exp3 (paper §5.1) — pure functions over a log-weight state [k]
# ---------------------------------------------------------------------------

def exp3_init(k: int, device="cuda") -> torch.Tensor:
    return torch.zeros((k,), dtype=torch.float32,
                       device=resolve_device(device))    # log weights

def exp3_probs(s: torch.Tensor) -> torch.Tensor:
    return torch.softmax(s, dim=-1)

def exp3_select(s: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Sample a model index from the Exp3 distribution (``generator`` lives
    on the state's device)."""
    return torch.multinomial(exp3_probs(s), 1, generator=generator)[..., 0]

LOG_WEIGHT_FLOOR = -20.0   # bounded pessimism: caps how far a model can fall
                           # behind, so recovery after healing is fast (the
                           # Fixed-Share-style behaviour visible in Fig 8)


def _renormalize(s: torch.Tensor) -> torch.Tensor:
    s = s - torch.logsumexp(s, dim=-1, keepdim=True)
    return torch.clamp_min(s, LOG_WEIGHT_FLOOR)


def exp3_observe(s: torch.Tensor, chosen: torch.Tensor, loss: torch.Tensor,
                 eta: float = 0.1) -> torch.Tensor:
    """w_i <- w_i * exp(-eta * L / p_i) for the selected model i. ``s``
    [..., k]; ``chosen`` (int) and ``loss`` (fp32) [...]."""
    idx = torch.as_tensor(chosen, dtype=torch.int64,
                          device=s.device)[..., None]
    loss = torch.as_tensor(loss, dtype=torch.float32, device=s.device)
    p = exp3_probs(s)
    upd = -eta * loss[..., None] / torch.clamp_min(p.gather(-1, idx), 1e-6)
    return _renormalize(s.scatter_add(-1, idx, upd))


# ---------------------------------------------------------------------------
# Exp4 (paper §5.2) — ensemble weights with per-model losses
# ---------------------------------------------------------------------------

def exp4_init(k: int, device="cuda") -> torch.Tensor:
    return torch.zeros((k,), dtype=torch.float32,
                       device=resolve_device(device))

def exp4_weights(s: torch.Tensor) -> torch.Tensor:
    return torch.softmax(s, dim=-1)

def exp4_combine(s: torch.Tensor, preds: torch.Tensor,
                 available: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted combination of base predictions.

    preds: [k, C] per-model class scores (or [k] scalars). available: [k]
    bool mask (straggler mitigation §5.2.2). Returns (combined, confidence)
    where confidence = weighted fraction of available models that agree with
    the final argmax (paper §5.2.1)."""
    preds = torch.as_tensor(preds, device=s.device).float()
    w = exp4_weights(s)
    if available is not None:
        available = torch.as_tensor(available, device=s.device)
        w = w * available
        w = w / torch.clamp_min(w.sum(), 1e-9)
    combined = torch.einsum("k,k...->...", w, preds)
    if preds.dim() > 1:
        final = torch.argmax(combined, dim=-1)
        votes = torch.argmax(preds, dim=-1)           # [k]
        agree = (votes == final).float()
    else:
        agree = torch.ones_like(w)
    mask = available.float() if available is not None else torch.ones_like(w)
    conf = torch.sum(agree * mask) / torch.clamp_min(torch.sum(mask), 1e-9)
    return combined, conf

def exp4_observe(s: torch.Tensor, losses: torch.Tensor, eta: float = 0.1,
                 available: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Down-weight each model by its own loss (losses in [0,1], [..., k])."""
    losses = torch.as_tensor(losses, dtype=torch.float32, device=s.device)
    if available is not None:
        available = torch.as_tensor(available, device=s.device)
        losses = torch.where(available, losses, 0.0)   # no update for missing
    return _renormalize(s - eta * losses)


def _host(policy, s: torch.Tensor) -> np.ndarray:
    """The state on the host: one device-to-host copy, counted."""
    policy.host_copies += 1
    return s.cpu().numpy()


# ---------------------------------------------------------------------------
# policy objects implementing the paper's Listing-2 interface
# ---------------------------------------------------------------------------

@dataclass
class Exp3Policy:
    """Single-model selection: one model evaluated per query (cheap)."""

    model_ids: Sequence[str]
    eta: float = 0.1
    device: Any = "cuda"
    host_copies: int = field(default=0, init=False, compare=False)

    def init(self):
        return exp3_init(len(self.model_ids), self.device)

    def select(self, s, x, rng: np.random.Generator) -> List[str]:
        # the caller's numpy generator draws, as the reference's does, so a
        # seed picks the same models in both packages
        p = _host(self, exp3_probs(s))
        i = int(rng.choice(len(p), p=p / p.sum()))
        return [self.model_ids[i]]

    def combine(self, s, x, preds: Dict[str, Any]):
        (mid, y), = preds.items()
        return y, 1.0

    def observe(self, s, x, loss_by_model: Dict[str, float], preds):
        (mid, loss), = loss_by_model.items()
        i = self.model_ids.index(mid)
        return exp3_observe(s, torch.tensor(i), torch.tensor(
            loss, dtype=torch.float32), self.eta)


@dataclass
class Exp4Policy:
    """Ensemble selection: all models evaluated, predictions combined
    (paper §5.2); supports straggler-masked combine (§5.2.2)."""

    model_ids: Sequence[str]
    eta: float = 0.1
    device: Any = "cuda"
    host_copies: int = field(default=0, init=False, compare=False)

    def init(self):
        return exp4_init(len(self.model_ids), self.device)

    def select(self, s, x, rng) -> List[str]:
        return list(self.model_ids)

    def combine(self, s, x, preds: Dict[str, Any]):
        if len(preds) == 1:
            # single prediction: pass through unchanged (weighted mean of
            # one element) — also lets structured dict/tuple outputs from
            # pipeline-style containers ride the plain frontend
            (_, y), = preds.items()
            return y, 1.0
        # numpy per query on the frontend host, as in the reference; the
        # batched state *updates* are torch (context.py)
        w = np.exp(np.asarray(_host(self, s), np.float64))
        avail = np.asarray([m in preds for m in self.model_ids])
        w = w * avail
        w = w / max(w.sum(), 1e-12)
        mean = np.mean([np.asarray(preds[m], np.float32)
                        for m in self.model_ids if m in preds], axis=0)
        mat = np.stack([np.asarray(preds[m], np.float32) if m in preds
                        else mean for m in self.model_ids])
        combined = np.einsum("k,k...->...", w, mat)
        if mat.ndim > 1:
            votes = mat.argmax(-1)
            conf = float(((votes == combined.argmax(-1)) & avail).sum()
                         / max(avail.sum(), 1))
        else:
            conf = 1.0
        return combined, conf

    def observe(self, s, x, loss_by_model: Dict[str, float], preds):
        losses = torch.tensor([loss_by_model.get(m, 0.0)
                               for m in self.model_ids], dtype=torch.float32)
        avail = torch.tensor([m in loss_by_model for m in self.model_ids])
        return exp4_observe(s, losses, self.eta, avail)
