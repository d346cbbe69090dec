"""Count what a step dispatches: the roofline's inputs (port of
``repro.launch.hlo_stats``, which parses compiled HLO; the file keeps its
name so the counterpart is found, but there is no HLO here).

:func:`count` runs a function under a ``TorchDispatchMode`` that sees every
aten op the function (its backward included) dispatches, on any device:
meta tensors count a step that no memory holds. It records

* dot FLOPs by input dtype: ``mm``, ``bmm``, ``addmm`` and ``baddbmm``,
  which ``matmul``, ``linear`` and ``einsum`` lower to (2 m k n each);
* each kernel's work, by the kernel's own formula (``repro_torch.kernels``:
  ``rmsnorm_work`` and the others), whatever runs it. Inside a kernel
  wrapper the aten ops are hidden: on the CPU those are the plain
  version's, on the card there are none, on meta the wrapper makes empty
  outputs, so a step counts the same on all three;
* memory: the bytes of the argument storages that some op (or kernel)
  reads or writes (an argument the step never touches is not counted, as
  XLA drops an unused argument), and the peak of live bytes in storages
  the function allocates, freed when their last reference goes (a storage
  is counted once, whatever views it has). An op's own scratch memory is
  no op's output; where it sets the peak it is modelled (``SCRATCH``, as
  ``scripts/launch_memory.py`` measured it on an H100): the softmax
  kernels copy a non-contiguous input before they run, softmax's backward
  also holds a buffer of its gradient's size, and ``logsumexp`` one of
  its input's. The training step's peak is inside
  ``_softmax_backward_data`` over the fp32 attention scores.

* collectives: given the ``mesh`` the step runs on, the calls and payload
  bytes its ``World.record`` gained during the call (a real world's or a
  counting rank's, ``launch.mesh.make_rank_mesh``, alike; a backward's
  collectives too), and from them the wire bytes a rank moves under the
  reference's ring model, g the group's size (``repro.launch.hlo_stats``):
  ``all_gather`` ("all-gather") its result x (g-1)/g, ``psum`` and
  ``pmax`` ("all-reduce") 2 x result x (g-1)/g, ``psum_scatter``
  ("reduce-scatter") its operand x (g-1)/g, and ``broadcast`` (its own
  key) the payload, which each rank but the root receives once. Beside
  the reference's fields by op, the wire bytes by axes
  (``collective_bytes_by_axes``, which the roofline prices a link at a
  time) and the payload by op, axes and dtype (``collective_payload``).

A Python loop is counted as it runs, so trip counts need no estimate
(``unknown_trip_whiles`` is 0), and one device moves no collective bytes.

PyTorch infers many meta outputs in Python (100-600 us an elementwise op
on a CPU host), which a time loop repeats thousands of times. So on meta
tensors the mode answers an op it has seen with the same arguments (the
same shapes, strides and dtypes, the same other values) from a cache of
its outputs' shapes, strides and dtypes; ops whose outputs share an
input's storage (views, in-place ops, ``_unsafe_view``) always run.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import Work, recording

aten = torch.ops.aten

DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64"}


@dataclass
class HloStats:
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    dot_flops: float = 0.0
    unknown_trip_whiles: int = 0
    dot_flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    # kernel name -> {"calls", "bytes", "flops": {dtype: operations}}
    kernel_work: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # argument_bytes (arguments used), peak_bytes (live, beyond the
    # arguments), output_bytes (outputs in storages the function
    # allocated), alias_bytes (outputs in the arguments' storages)
    memory: Dict[str, int] = field(default_factory=dict)
    # "pod,data" -> wire bytes over those axes
    collective_bytes_by_axes: Dict[str, float] = field(default_factory=dict)
    # "op/axes/dtype" -> {"calls", "bytes"}: what the ranks handed over
    collective_payload: Dict[str, Dict[str, int]] = field(
        default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def to_dict(self):
        """The reference's fields and the port's; the per-axes and payload
        fields only where a collective ran, so one device's record keeps
        its keys."""
        out = {
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "dot_flops": self.dot_flops,
            "unknown_trip_whiles": self.unknown_trip_whiles,
            "dot_flops_by_dtype": dict(self.dot_flops_by_dtype),
            "kernel_work": {k: {"calls": w["calls"], "bytes": w["bytes"],
                                "flops": dict(w["flops"])}
                            for k, w in self.kernel_work.items()},
        }
        if self.collective_payload:
            out["collective_bytes_by_axes"] = dict(
                self.collective_bytes_by_axes)
            out["collective_payload"] = {
                k: dict(v) for k, v in self.collective_payload.items()}
        return out


# the port's collective -> (the reference's op, wire bytes a rank moves
# for ``payload`` bytes handed over in a group of g)
WIRE = {
    "all_gather": ("all-gather", lambda b, g: float(b) * (g - 1)),  # g b
    "psum": ("all-reduce", lambda b, g: 2.0 * b * (g - 1) / g),
    "pmax": ("all-reduce", lambda b, g: 2.0 * b * (g - 1) / g),
    "psum_scatter": ("reduce-scatter", lambda b, g: b * (g - 1) / g),
    "broadcast": ("broadcast", lambda b, g: float(b) if g > 1 else 0.0),
}


def _add_collectives(stats: HloStats, mesh, calls, nbytes) -> None:
    """Fill ``stats``' collective fields from the calls and payload bytes
    by (op, axes, dtype) that ``mesh``'s record gained."""
    for key in sorted(calls):
        op, axes, dt = key
        name, wire = WIRE[op]
        b = wire(nbytes[key], mesh.size(axes))
        stats.collective_counts[name] = (stats.collective_counts.get(name, 0)
                                         + calls[key])
        stats.collective_bytes[name] = (stats.collective_bytes.get(name, 0.0)
                                        + b)
        ax = ",".join(axes)
        stats.collective_bytes_by_axes[ax] = (
            stats.collective_bytes_by_axes.get(ax, 0.0) + b)
        stats.collective_payload[f"{op}/{ax}/{dt}"] = {
            "calls": calls[key], "bytes": nbytes[key]}


def _tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _dot(func, args) -> Optional[tuple]:
    """(FLOPs, input dtype) of a matrix product, or None."""
    packet = func.overloadpacket
    if packet in (aten.addmm, aten.baddbmm):
        args = args[1:]
    elif packet not in (aten.mm, aten.bmm):
        return None
    a, b = args[0], args[1]
    n = 2 * a.shape[-2] * a.shape[-1] * b.shape[-1]
    if a.dim() == 3:
        n *= a.shape[0]
    return float(n), DTYPE_NAMES.get(a.dtype, str(a.dtype))


_SCALARS = (bool, int, float, str, torch.dtype, torch.device, torch.layout,
            torch.memory_format)


class _NoKey(Exception):
    pass


def _key(x):
    """A hashable description of an op argument for the meta cache (the
    type goes in too: ``1``, ``1.0`` and ``True`` hash alike)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoKey
        return (x.size(), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    if x is None or isinstance(x, _SCALARS):
        return (type(x), x)
    raise _NoKey


def _flat(args, kwargs) -> list:
    """The tensors among an op's arguments (lists one level deep)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _copies(args) -> int:
    """Bytes of the non-contiguous tensors among ``args``: the copies a
    kernel that needs contiguous inputs makes."""
    return sum(t.numel() * t.element_size() for t in _flat(args, {})
               if not t.is_contiguous())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# op -> bytes of scratch it holds while it runs, beyond its outputs, from
# its arguments (measured on an H100 by scripts/launch_memory.py)
SCRATCH = {
    aten._softmax.default: _copies,
    aten._log_softmax.default: _copies,
    aten._log_softmax_backward_data.default: _copies,
    aten._softmax_backward_data.default:
        lambda args: _nbytes(args[0]) + _copies(args),
    aten.logsumexp.default: lambda args: _nbytes(args[0]),
}


@functools.lru_cache(maxsize=None)
def _fresh(func) -> Tuple[bool, ...]:
    """Per return of ``func``'s schema: True where it is a new tensor (no
    alias of an input: not a view, not an in-place or out= result)."""
    return tuple(r.alias_info is None for r in func._schema.returns)


class _Counter(TorchDispatchMode):
    def __init__(self, stats: HloStats, arg_storages: Dict[int, int]):
        super().__init__()
        self.stats = stats
        self.args = arg_storages           # id(storage) -> bytes
        self.unused = set(arg_storages)    # argument storages not yet used
        self.live: Dict[int, int] = {}     # storages allocated here
        self.cur = 0
        self.peak = 0
        self.hide = 0
        # (op, argument keys) -> (is a tuple, [(shape, stride, dtype)] of
        # its outputs), or None where outputs cannot be made from metadata
        self.meta_cache: Dict[Any, Any] = {}

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, from the meta cache where it can."""
        try:
            key = (func, _key(args), _key(tuple(kwargs.items())))
        except _NoKey:
            return func(*args, **kwargs)
        hit = self.meta_cache.get(key, False)
        if hit:
            outs = tuple(torch.empty_strided(shape, stride, dtype=dt,
                                             device="meta")
                         for shape, stride, dt in hit[1])
            return outs if hit[0] else outs[0]
        out = func(*args, **kwargs)
        if hit is None:
            return out
        outs = out if isinstance(out, tuple) else (out,)
        # a fresh schema is not enough: _unsafe_view's output shares its
        # input's storage
        ins = {id(t.untyped_storage()) for t in _flat(args, kwargs)}
        ok = all(_fresh(func)) and all(
            isinstance(t, torch.Tensor) and t.device.type == "meta"
            and t.storage_offset() == 0
            and id(t.untyped_storage()) not in ins
            and t.untyped_storage().nbytes() == torch.empty_strided(
                t.shape, t.stride(), dtype=t.dtype,
                device="meta").untyped_storage().nbytes()
            for t in outs)
        self.meta_cache[key] = ((isinstance(out, tuple),
                                 [(t.shape, t.stride(), t.dtype)
                                  for t in outs]) if ok else None)
        return out

    # --- the recorder interface of repro_torch.kernels ---
    @contextlib.contextmanager
    def hidden(self):
        self.hide += 1
        try:
            yield
        finally:
            self.hide -= 1

    def kernel(self, name: str, work: Work, inputs, outputs) -> None:
        w = self.stats.kernel_work.setdefault(
            name, {"calls": 0, "bytes": 0.0, "flops": {}})
        w["calls"] += 1
        w["bytes"] += float(work.bytes)
        for dt, n in work.flops.items():
            w["flops"][dt] = w["flops"].get(dt, 0.0) + float(n)
        self._use(inputs)
        for t in _flat(outputs if isinstance(outputs, tuple) else
                       (outputs,), {}):
            self._new(t)

    # --- memory ---
    def _use(self, tensors) -> None:
        """Mark the argument storages among ``tensors`` used."""
        if self.unused:
            self.unused.difference_update(
                id(t.untyped_storage()) for t in tensors)

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def _new(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as allocated here, once."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.live or key in self.args:
            return
        self.live[key] = st.nbytes()
        self.cur += self.live[key]
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.hide:
            return func(*args, **kwargs)
        out = self._run(func, args, kwargs)
        if self.unused:
            self._use(_flat(args, kwargs))
        dot = _dot(func, args)
        if dot is not None:
            n, dt = dot
            self.stats.dot_flops += n
            by = self.stats.dot_flops_by_dtype
            by[dt] = by.get(dt, 0.0) + n
        fresh = _fresh(func)
        if isinstance(out, torch.Tensor):
            if fresh[0]:
                self._new(out)
        elif isinstance(out, (tuple, list)):
            flags = fresh * len(out) if isinstance(out, list) else fresh
            for t, f in zip(out, flags):
                if f and isinstance(t, torch.Tensor):
                    self._new(t)
        if func in SCRATCH:
            self.peak = max(self.peak, self.cur + SCRATCH[func](args))
        return out


def _storages(tree) -> Dict[int, Any]:
    return {id(t.untyped_storage()): t.untyped_storage()
            for t in _tensors(tree)}


def count(fn: Callable, *args, mesh=None) -> HloStats:
    """Run ``fn(*args)`` and count what it dispatched (see the module
    docstring), and the collectives it ran on ``mesh`` where it has a
    world; its result is dropped."""
    stats = HloStats()
    arg_st = _storages(args)
    mode = _Counter(stats, {k: s.nbytes() for k, s in arg_st.items()})
    rec = (mesh.world.record if mesh is not None and mesh.world is not None
           else None)
    if rec is not None:
        calls0, bytes0 = dict(rec.calls), dict(rec.bytes)
    with mode, recording(mode):
        out = fn(*args)
    if rec is not None:
        calls = {k: n - calls0.get(k, 0) for k, n in rec.calls.items()
                 if n > calls0.get(k, 0)}
        _add_collectives(stats, mesh, calls,
                         {k: rec.bytes[k] - bytes0.get(k, 0) for k in calls})
    out_st = _storages(out)
    stats.memory = {
        "argument_bytes": sum(n for k, n in mode.args.items()
                              if k not in mode.unused),
        "peak_bytes": mode.peak,
        "output_bytes": sum(s.nbytes() for k, s in out_st.items()
                            if k not in arg_st),
        "alias_bytes": sum(s.nbytes() for k, s in out_st.items()
                           if k in arg_st),
    }
    return stats


def extrapolate(a: HloStats, b: HloStats, x_a: float, x_b: float,
                x: float) -> HloStats:
    """The counts at ``x`` of a step whose every count is affine in ``x``
    (memory and collectives included), from its counts at ``x_a`` and
    ``x_b``; both must have called the same kernels and collectives."""
    t = (x - x_a) / (x_b - x_a)

    def lerp(u, v, key=""):
        if isinstance(u, dict):
            if set(u) != set(v):
                raise ValueError(f"extrapolate: {key or 'counts'} differ in "
                                 f"keys: {sorted(u)} and {sorted(v)}")
            return {k: lerp(u[k], v[k], k) for k in u}
        y = u + (v - u) * t
        return int(round(y)) if isinstance(u, int) else y

    fields = ("dot_flops", "dot_flops_by_dtype", "kernel_work", "memory",
              "collective_counts", "collective_bytes",
              "collective_bytes_by_axes", "collective_payload")
    return HloStats(**{f: lerp(getattr(a, f), getattr(b, f), f)
                       for f in fields})
