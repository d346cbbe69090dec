"""Clipper's narrow-waist interfaces (paper §3, Listings 1 & 2).

``pred_batch`` is the uniform batch prediction interface every model
container implements; ``SelectionPolicy`` is the select/combine/observe API
that all model-selection techniques are expressed in."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np


@dataclass
class Query:
    query_id: int
    x: Any                                  # model input (np array / token ids)
    context_id: int = 0                     # user / session (paper §5.3)
    arrival_time: float = 0.0
    deadline: Optional[float] = None        # absolute; set from the SLO


@dataclass
class Prediction:
    query_id: int
    y: Any
    confidence: float = 1.0
    model_ids: Tuple[str, ...] = ()
    latency: float = 0.0
    from_cache: bool = False
    missing_models: Tuple[str, ...] = ()    # straggler-dropped (paper §5.2.2)


@dataclass
class Feedback:
    query_id: int
    x: Any
    y_true: Any
    context_id: int = 0


@runtime_checkable
class ModelContainer(Protocol):
    """Paper Listing 1: the common batch prediction interface."""

    model_id: str

    def pred_batch(self, inputs: Sequence[Any]) -> List[Any]:
        """Evaluate a batch; returns one output per input."""
        ...


class SelectionPolicy(Protocol):
    """Paper Listing 2: init / select / combine / observe."""

    def init(self) -> Any:
        ...

    def select(self, s: Any, x: Any, rng: np.random.Generator) -> List[str]:
        ...

    def combine(self, s: Any, x: Any, preds: Dict[str, Any]
                ) -> Tuple[Any, float]:
        ...

    def observe(self, s: Any, x: Any, y_true: Any,
                preds: Dict[str, Any]) -> Any:
        ...


Clock = Callable[[], float]


def monotonic_clock() -> float:
    return time.monotonic()
