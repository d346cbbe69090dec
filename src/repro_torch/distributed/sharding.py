"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Model code names a tensor's dims with *logical* axes; a rules table maps
them to mesh axes (MaxText-style). The port runs on one device, which has
nothing to place: ``shard`` returns its input, and ``ShardingContext.
sharding`` returns the :class:`PartitionSpec` the reference would place by.
The rule tables, the spec (a mesh axis used at most once, trailing
``None``s trimmed) and the context's thread-local stay the reference's,
so a sharded port can read them as they are.

Rules used in production (DESIGN.md §6):
    batch   -> ('pod', 'data')   [or ('data',) single-pod]
    fsdp    -> 'data'            (train param sharding; None at serve)
    heads/kv_heads/ffn/vocab/expert -> 'model'
    embed/seq/state -> None      (replicated dims)

Not carried over: ``compat_shard_map``, ``compat_axis_size`` and
``_shard_map_check_kwarg``, shims between JAX versions' ``shard_map`` and
``axis_size`` APIs that only a multi-device program calls.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

AxisVal = Union[None, str, Tuple[str, ...]]

_state = threading.local()


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: ``None``, an axis name or a tuple of
    names. A tuple of one name is that name and an empty one is ``None``,
    as ``jax.sharding.PartitionSpec`` normalizes them, so ``tuple(spec)``
    equals ``tuple(jax.sharding.PartitionSpec(*dims))``."""

    def __new__(cls, dims=()):
        def norm(d):
            if isinstance(d, tuple) and len(d) <= 1:
                return d[0] if d else None
            return d
        return super().__new__(cls, (norm(d) for d in dims))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class ShardingContext:
    def __init__(self, mesh, rules: Dict[str, AxisVal]):
        self.mesh = mesh
        self.rules = dict(rules)

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        out = []
        used = set()
        for ax in logical_axes:
            m = self.rules.get(ax) if ax else None
            # a mesh axis may appear at most once in a PartitionSpec
            if m is not None:
                was_tuple = not isinstance(m, str)
                flat = (m,) if isinstance(m, str) else tuple(m)
                flat = tuple(a for a in flat
                             if a not in used and a in self.mesh.axis_names)
                used.update(flat)
                m = (flat or None) if was_tuple else (flat[0] if flat else None)
            out.append(m)
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(out)

    def sharding(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        """The spec: one device places nothing by it."""
        return self.spec(logical_axes)


def current() -> Optional[ShardingContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def sharding_context(mesh, rules: Dict[str, AxisVal]):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ShardingContext(mesh, rules)
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


def shard(x, *logical_axes: Optional[str]):
    """Annotate an intermediate with logical axes: ``x`` itself on one
    device, as the reference without a context."""
    return x


# ---------------------------------------------------------------------------
# standard rule tables
# ---------------------------------------------------------------------------

def train_rules(multi_pod: bool) -> Dict[str, AxisVal]:
    batch = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "fsdp": "data",
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "expert": "model",
        "expert_ffn": None,
        "embed": None,
        "seq": None,
        "state": None,
        "users": batch,
    }


def strip_pod(rules: Dict[str, AxisVal]) -> Dict[str, AxisVal]:
    """Remove the pod axis from batch-like rules — used when the pod dim is
    handled manually by the cross-pod gradient mean (train path)."""
    out = dict(rules)
    for k in ("batch", "users"):
        v = out.get(k)
        if isinstance(v, tuple):
            v = tuple(a for a in v if a != "pod")
            out[k] = v if v else None
        elif v == "pod":
            out[k] = None
    return out


def norm_axes(v: AxisVal) -> Tuple[str, ...]:
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def serve_rules(multi_pod: bool,
                shard_experts_2d: bool = False) -> Dict[str, AxisVal]:
    rules = train_rules(multi_pod)
    rules["fsdp"] = None          # weights replicated over data at serve
    if shard_experts_2d:          # kimi-scale MoE: expert d_ff also over data
        rules["expert_ffn"] = "data"
    return rules


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def params_shardings(axes_tree, ctx: ShardingContext):
    """Map a tree of logical-axes tuples (dicts, lists and tuples of them)
    to specs."""
    if _is_axes(axes_tree):
        return ctx.sharding(axes_tree)
    if isinstance(axes_tree, dict):
        return {k: params_shardings(v, ctx) for k, v in axes_tree.items()}
    if isinstance(axes_tree, (tuple, list)):
        out = [params_shardings(v, ctx) for v in axes_tree]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*out)
        return type(axes_tree)(out)
    return axes_tree
