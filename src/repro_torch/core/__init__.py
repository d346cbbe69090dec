"""Clipper core, counterpart of ``repro.core``: the paper's contribution
as composable PyTorch modules, and the host substrate the serving stacks
share.

Layers (paper Figure 1):
  model selection  - selection.py (Exp3/Exp4), context.py, straggler.py
  model abstraction - cache.py (CLOCK), batching.py (AIMD), containers.py
  frontend          - frontend.py (REST-equivalent: submit / feedback)
"""

from repro_torch.core.batching import (AIMDController, BatchQueue,
                                       FixedController,
                                       QuantileRegressionController, bucket)
from repro_torch.core.cache import ClockCache, PredictionCache
from repro_torch.core.containers import (ReplicaSet, TorchModelContainer,
                                         linear_latency)
from repro_torch.core.context import ContextualStore
from repro_torch.core.frontend import Clipper, make_clipper
from repro_torch.core.interfaces import Feedback, Prediction, Query
from repro_torch.core.metrics import (MetricsRegistry, StreamingHistogram,
                                      VirtualClock)
from repro_torch.core.selection import (Exp3Policy, Exp4Policy, exp3_init,
                                        exp3_observe, exp3_probs,
                                        exp4_combine, exp4_init, exp4_observe,
                                        exp4_weights)
from repro_torch.core.straggler import DeadlineTracker, assemble_preds

__all__ = [
    "AIMDController", "BatchQueue", "FixedController",
    "QuantileRegressionController", "bucket", "ClockCache", "PredictionCache",
    "TorchModelContainer", "ReplicaSet", "linear_latency", "ContextualStore",
    "Clipper", "make_clipper", "Feedback", "Prediction", "Query",
    "Exp3Policy", "Exp4Policy", "exp3_init", "exp3_observe", "exp3_probs",
    "exp4_combine", "exp4_init", "exp4_observe", "exp4_weights",
    "DeadlineTracker", "assemble_preds",
    "MetricsRegistry", "StreamingHistogram", "VirtualClock",
]
