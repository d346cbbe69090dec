"""Hand-written Hopper kernels for the serving path, one directory each:
``<name>.py`` binds the kernel, ``ops.py`` is the checked wrapper the model
calls (plain version on CPU tensors, kernel on CUDA tensors, never a
fallback), ``ref.py`` is the plain PyTorch version. CUDA sources live in
``repro_torch/csrc`` and build on first use (``_build.py``).

Every wrapper counts its kernel's launches in ``<wrapper>.launches``, added
to where it launches and nowhere else. A wrapper called while a CUDA graph
is captured launches nothing then: whoever captures takes the counts of the
capture back and credits them on every replay (:func:`launch_counts`,
:func:`credit_launches`), so a count keeps meaning kernel launches.

No kernel has a backward: a wrapper that would launch its kernel on an
input that needs a gradient raises (:func:`refuse_autograd`) rather than
return an output cut from the graph. The training forward takes the plain
versions.

On meta tensors (shapes only) a wrapper returns empty outputs of the plain
version's shapes and dtypes and computes nothing. Each ``ops.py`` also
gives its kernel's :class:`Work`, read from shapes; while a recorder is
active (:func:`recording`; ``repro_torch.launch.hlo_stats.count``) every
wrapper call, on any device, hands the recorder its work and its outputs,
and hides the aten ops that compute them, so a step counts the same on
meta, CPU and CUDA tensors."""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

_COUNTED: List[Callable] = []
_RECORDER = threading.local()


class Work(NamedTuple):
    """What one kernel call must do: the bytes it must move (each input
    read once, each output written once) and its operations by the dtype
    whose peak rate they run at (``"bf16"``: tensor cores; ``"f32"``)."""

    bytes: float
    flops: Dict[str, float]


def recorder() -> Optional[Any]:
    """The active recorder of this thread, or None."""
    return getattr(_RECORDER, "active", None)


@contextlib.contextmanager
def recording(rec):
    """Make ``rec`` this thread's recorder: it needs ``hidden()``, a context
    inside which it ignores the ops it sees, and ``kernel(name, work,
    input tensors, outputs)``."""
    prev = recorder()
    _RECORDER.active = rec
    try:
        yield rec
    finally:
        _RECORDER.active = prev


def counted(name: str, work: Callable[..., Work]) -> Callable:
    """Decorator of kernel ``name``'s wrapper: give it its launch count
    (``wrapper.launches = 0``), register it with :func:`launch_counts`, and
    under a recorder report each call's ``work(*args, **kwargs)``."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            rec = recorder()
            if rec is None:
                return fn(*args, **kwargs)
            with rec.hidden():
                out = fn(*args, **kwargs)
            rec.kernel(name, work(*args, **kwargs),
                       [a for a in (*args, *kwargs.values())
                        if isinstance(a, torch.Tensor)], out)
            return out
        wrapper.launches = 0
        _COUNTED.append(wrapper)
        return wrapper
    return deco


def launch_counts() -> Dict[Callable, int]:
    """Each registered wrapper's launch count."""
    return {w: w.launches for w in _COUNTED}


def credit_launches(counts: Dict[Callable, int]) -> None:
    """Add ``counts`` to the wrappers' launch counts (negative: take back)."""
    for w, n in counts.items():
        w.launches += n


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd is on and one of ``tensors`` requires a gradient:
    the kernel writes into a fresh buffer, so its output would have no
    ``grad_fn`` and ``backward()`` would leave the inputs' gradients
    silently missing."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires a "
            f"gradient; run it under torch.no_grad() or take the plain "
            f"version (the models' train=True forward)")


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
