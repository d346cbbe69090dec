"""Hand-written Hopper kernels for the serving path, one directory each:
``<name>.py`` binds the kernel, ``ops.py`` is the checked wrapper the model
calls (plain version on CPU tensors, kernel on CUDA tensors, never a
fallback), ``ref.py`` is the plain PyTorch version. CUDA sources live in
``repro_torch/csrc`` and build on first use (``_build.py``).

Every wrapper counts its kernel's launches in ``<wrapper>.launches``, added
to where it launches and nowhere else. A wrapper called while a CUDA graph
is captured launches nothing then: whoever captures takes the counts of the
capture back and credits them on every replay (:func:`launch_counts`,
:func:`credit_launches`), so a count keeps meaning kernel launches."""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional

import torch

_COUNTED: List[Callable] = []


def counted(wrapper: Callable) -> Callable:
    """Give a kernel wrapper its launch count (``wrapper.launches = 0``)
    and register it with :func:`launch_counts`."""
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


def launch_counts() -> Dict[Callable, int]:
    """Each registered wrapper's launch count."""
    return {w: w.launches for w in _COUNTED}


def credit_launches(counts: Dict[Callable, int]) -> None:
    """Add ``counts`` to the wrappers' launch counts (negative: take back)."""
    for w, n in counts.items():
        w.launches += n


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
