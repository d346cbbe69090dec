"""Contextualization (paper §5.3): per-user / per-session selection state.

Counterpart of ``repro.core.context``. The paper keeps per-session bandit
state in Redis. Here the store is a ``[num_users, k]`` fp32 tensor on one
device, and feedback is applied in batched updates: one gather of the
batch's rows, one Exp3/Exp4 update over all of them, one scatter back.

A batch may name a user more than once. Every row's update is computed from
the state before the batch, and the user's last occurrence in the batch is
the one that lands, as the reference's ``states.at[u].set(new)`` resolves on
XLA's CPU. A scatter with repeated indices has no defined winner on CUDA, so
the store keeps each user's last occurrence before it scatters."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.selection import (
    exp3_observe, exp3_probs, exp4_combine, exp4_observe,
)
from repro_torch.models.api import resolve_device


def _last_occurrence(users: np.ndarray) -> np.ndarray:
    """Positions of each distinct value's last occurrence in ``users``."""
    _, first_from_end = np.unique(users[::-1], return_index=True)
    return np.sort(len(users) - 1 - first_from_end)


class ContextualStore:
    """[num_users, k] bandit states with batched updates, on ``device``."""

    def __init__(self, num_users: int, k: int, *, kind: str = "exp4",
                 eta: float = 0.1, device="cuda"):
        self.num_users = num_users
        self.k = k
        self.kind = kind
        self.eta = eta
        self.device = resolve_device(device)
        self.states = torch.zeros((num_users, k), dtype=torch.float32,
                                  device=self.device)

    def state_for(self, user: int) -> torch.Tensor:
        return self.states[user % self.num_users]

    def probs_for(self, user: int) -> np.ndarray:
        return exp3_probs(self.state_for(user)).cpu().numpy()

    # ---- batched feedback paths ----
    def _put(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

    def _scatter(self, users: np.ndarray, u: torch.Tensor,
                 new: torch.Tensor) -> None:
        keep = _last_occurrence(users)
        if len(keep) < len(u):
            sel = self._put(keep, np.int64)
            u, new = u[sel], new[sel]
        self.states[u] = new

    def observe_exp3(self, users: np.ndarray, chosen: np.ndarray,
                     losses: np.ndarray) -> None:
        users = np.asarray(users) % self.num_users
        u = self._put(users, np.int64)
        new = exp3_observe(self.states[u], self._put(chosen, np.int64),
                           self._put(losses, np.float32), self.eta)
        self._scatter(users, u, new)

    def observe_exp4(self, users: np.ndarray, losses: np.ndarray,
                     available: Optional[np.ndarray] = None) -> None:
        users = np.asarray(users) % self.num_users
        u = self._put(users, np.int64)
        if available is None:
            available = np.ones_like(losses, dtype=bool)
        new = exp4_observe(self.states[u], self._put(losses, np.float32),
                           self.eta, self._put(available, bool))
        self._scatter(users, u, new)

    def combine_for(self, user: int, preds_matrix, available=None):
        return exp4_combine(self.state_for(user), preds_matrix, available)

    # ---- checkpoint integration ----
    def state_dict(self):
        return {"states": np.array(self.states.cpu()), "kind": self.kind,
                "eta": self.eta}

    def load_state_dict(self, d) -> None:
        states = torch.tensor(np.asarray(d["states"]), dtype=torch.float32)
        if tuple(states.shape) != (self.num_users, self.k):
            raise ValueError(f"states {tuple(states.shape)} do not fit a "
                             f"store of {(self.num_users, self.k)}")
        self.states = states.to(self.device)
