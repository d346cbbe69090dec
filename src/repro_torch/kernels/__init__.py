"""Hand-written Hopper kernels for the serving path, one directory each:
``<name>.py`` binds the kernel, ``ops.py`` is the checked wrapper the model
calls (plain version on CPU tensors, kernel on CUDA tensors, never a
fallback), ``ref.py`` is the plain PyTorch version. CUDA sources live in
``repro_torch/csrc`` and build on first use (``_build.py``)."""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch


@functools.lru_cache(maxsize=None)
def softmax_scale(scale: Optional[float], head_dim: int,
                  dtype: torch.dtype = torch.bfloat16) -> float:
    """The attention softmax scale (default ``1/sqrt(head_dim)``) as
    ``q * scale`` applies it to a ``dtype`` array: rounded to ``dtype``
    first, as JAX rounds a Python float multiplied into a bf16 array. The
    plain versions and the kernels' wrappers both take it from here; cached,
    so a layer's call makes no tensor."""
    s = scale or 1.0 / math.sqrt(head_dim)
    return float(torch.tensor(s, dtype=dtype))
