"""Logical-axis sharding rules and the collectives (port of
``repro.distributed.sharding``).

Model code names a tensor's dims with *logical* axes; a rules table maps
them to mesh axes (MaxText-style). ``shard`` returns its input: the port
places nothing by annotation. The rule tables, the spec (a mesh axis used
at most once, trailing ``None``s trimmed) and the context's thread-local
stay the reference's.

Where the reference writes its collectives inside ``shard_map`` bodies
(``lax.all_gather``, ``psum``, ``psum_scatter``, ``pmean``,
``axis_index``), the port runs SPMD programs on ``torch.distributed``:
each rank calls the functions below on its own tensors, by axis name, on
the process groups of a :class:`repro_torch.launch.mesh.Mesh` that spans a
world. On a mesh without a world every axis has size 1 and each
collective returns its input. :func:`local_slice` cuts a rank's block out
of a global tensor by a :class:`PartitionSpec`, and :func:`gather_global`
puts one back together.

Gradients pass through every collective as its adjoint: ``all_gather`` ↔
``psum_scatter``, and ``psum`` (and ``pmean``) ↔ itself. So each rank
back-propagates its own loss, and a parameter that several ranks hold
has its gradient summed over them (``training.grad_compress``).

Every call is counted on the mesh's ``world.record`` (op, axes, dtype:
calls and bytes), with the bytes copied through host memory where gloo
carries a card's tensors. On a counting rank (``launch.mesh.
make_rank_mesh``, backend ``"count"``) that record is all a call does: it
returns an empty tensor of the shape and dtype the real collective returns
and touches no ``torch.distributed``, so a rank's step, backward included,
runs on meta with its collectives counted.

Rules used in production (DESIGN.md §6):
    batch   -> ('pod', 'data')   [or ('data',) single-pod]
    fsdp    -> 'data'            (train param sharding; None at serve)
    heads/kv_heads/ffn/vocab/expert -> 'model'
    embed/seq/state -> None      (replicated dims)

Not carried over: ``compat_shard_map``, ``compat_axis_size`` and
``_shard_map_check_kwarg``, shims between JAX versions' ``shard_map`` and
``axis_size`` APIs.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]

_state = threading.local()


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: ``None``, an axis name or a tuple of
    names. A tuple of one name is that name and an empty one is ``None``,
    as ``jax.sharding.PartitionSpec`` normalizes them, so ``tuple(spec)``
    equals ``tuple(jax.sharding.PartitionSpec(*dims))``.

    ``parts`` (per dim, 1 where not given) says a dim is that many equal
    pieces side by side, each split over the dim's axes on its own: a
    rank's block of the dim is its block of every piece, in order (hymba's
    ``w_in``, x ‖ z, and ``w_bc``, B ‖ C, so a rank holds x_r ‖ z_r and
    computes whole heads). :func:`block_slices` and :func:`gather_global`
    are the one place that maps such a block to and from the global
    tensor."""

    def __new__(cls, dims=(), parts=()):
        def norm(d):
            if isinstance(d, tuple) and len(d) <= 1:
                return d[0] if d else None
            return d
        self = super().__new__(cls, (norm(d) for d in dims))
        self.parts = tuple(int(p) for p in parts)
        return self

    def part(self, dim: int) -> int:
        """The number of pieces dim ``dim`` is made of."""
        return self.parts[dim] if dim < len(self.parts) else 1

    def __repr__(self) -> str:
        extra = (f", parts={self.parts}" if any(p > 1 for p in self.parts)
                 else "")
        return f"PartitionSpec{tuple.__repr__(self)}{extra}"


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


# ---------------------------------------------------------------------------
# collectives by axis name (the reference's lax collectives inside
# shard_map bodies)
# ---------------------------------------------------------------------------

def _mesh_of(mesh):
    if mesh is not None:
        return mesh
    ctx = current()
    if ctx is None:
        raise ValueError("a collective needs a mesh: pass mesh= or enter "
                         "sharding_context")
    return ctx.mesh


def axis_size(axes, *, mesh=None) -> int:
    """The number of ranks along ``axes`` (a name or a tuple of names)."""
    return _mesh_of(mesh).size(axes)


def axis_index(axes, *, mesh=None) -> int:
    """This rank's index along ``axes``: row-major over them in the mesh's
    order, as ``lax.axis_index`` numbers a tuple of axes."""
    return _mesh_of(mesh).index(axes)


def _group(mesh, axes):
    """(names, world) of a collective over ``axes``; (names, None) where
    every one of them has size 1 and there is no world to ask."""
    names = mesh.axes(axes)
    if mesh.world is None:
        if mesh.size(names) != 1:
            raise ValueError(f"a collective over {names} of {mesh.shape} "
                             f"needs a mesh over a torch.distributed world "
                             f"(launch.mesh.make_mesh after init_world)")
        return names, None
    return names, mesh.world


def _staged(world, t: torch.Tensor) -> torch.Tensor:
    """The tensor the transport is given: a host copy of card memory under
    gloo (counted), else ``t``."""
    if world.staged and t.device.type != "cpu":
        world.record.staged_bytes += t.numel() * t.element_size()
        return t.cpu()
    return t


def _back(world, t: torch.Tensor, device) -> torch.Tensor:
    if t.device != device:
        world.record.staged_bytes += t.numel() * t.element_size()
        return t.to(device)
    return t


def _gather_single():
    """The flat all-gather under its current name (``all_gather_single``
    from torch 2.13 on, ``all_gather_into_tensor`` before)."""
    import torch.distributed as dist
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


def _scatter_single():
    import torch.distributed as dist
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


def _counted(world, op: str, names, x: torch.Tensor) -> bool:
    """Record one call on ``world``: the one recording path of every
    transport. True on a counting rank, where the call does nothing else."""
    world.record.add(op, names, x)
    return world.backend == "count"


def _resized(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """An empty tensor like ``x`` whose dim ``dim`` is ``length`` long: what
    a counting rank's collective returns."""
    shape = list(x.shape)
    shape[dim] = length
    return x.new_empty(shape)


def _all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"):
    import torch.distributed as dist

    names, world = _group(mesh, axes)
    if world is None:
        return x
    if _counted(world, "psum" if op == "sum" else "pmax", names, x):
        return x.new_empty(x.shape)
    buf = _staged(world, x.detach().contiguous())
    if buf.data_ptr() == x.data_ptr():            # reduce into a copy
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=world.groups[names])
    return _back(world, buf, x.device)


def _all_gather(x: torch.Tensor, mesh, axes, dim: int):
    import torch.distributed as dist

    names, world = _group(mesh, axes)
    if world is None:
        return x
    n = mesh.size(names)
    if _counted(world, "all_gather", names, x):
        return _resized(x, dim, x.shape[dim] * n)
    src = _staged(world, x.detach().movedim(dim, 0).contiguous())
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _gather_single()(out, src, group=world.groups[names])
    out = _back(world, out, x.device)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


def _psum_scatter(x: torch.Tensor, mesh, axes, dim: int):
    import torch.distributed as dist

    names, world = _group(mesh, axes)
    if world is None:
        return x
    n = mesh.size(names)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not split {n} ways")
    if _counted(world, "psum_scatter", names, x):
        return _resized(x, dim, x.shape[dim] // n)
    src = _staged(world, x.detach().movedim(dim, 0).contiguous())
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _scatter_single()(out, src, op=dist.ReduceOp.SUM,
                      group=world.groups[names])
    out = _back(world, out, x.device)
    return out if dim == 0 else out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _psum_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, *ctx.args), None, None


def all_gather(x: torch.Tensor, axis, dim: int = 0, *,
               mesh=None) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: the ranks' blocks
    along ``dim``, in rank order. Its gradient is ``psum_scatter``'s."""
    return _AllGather.apply(x, _mesh_of(mesh), axis, dim)


def psum_scatter(x: torch.Tensor, axis, dim: int = 0, *,
                 mesh=None) -> torch.Tensor:
    """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
    the sum over the ranks, of which each keeps its block along ``dim``.
    Its gradient is ``all_gather``'s."""
    return _PsumScatter.apply(x, _mesh_of(mesh), axis, dim)


def psum(x: torch.Tensor, axes, *, mesh=None) -> torch.Tensor:
    """``lax.psum(x, axes)``: the sum over the ranks along ``axes``; its
    gradient is the psum of the ranks' gradients."""
    return _Psum.apply(x, _mesh_of(mesh), axes)


def pmean(x: torch.Tensor, axes, *, mesh=None) -> torch.Tensor:
    """``lax.pmean(x, axes)``."""
    mesh = _mesh_of(mesh)
    return psum(x, axes, mesh=mesh) / mesh.size(axes)


def pmax(x: torch.Tensor, axes, *, mesh=None) -> torch.Tensor:
    """The elementwise max over the ranks along ``axes`` (no gradient)."""
    return _all_reduce(x, _mesh_of(mesh), axes, op="max")


def broadcast(x: torch.Tensor, axes, *, mesh=None) -> torch.Tensor:
    """Every rank along ``axes`` gets the first one's ``x`` (in place
    where the transport reads ``x`` itself; returns the result)."""
    import torch.distributed as dist

    mesh = _mesh_of(mesh)
    names, world = _group(mesh, axes)
    if world is None:
        return x
    if _counted(world, "broadcast", names, x):
        return x
    buf = _staged(world, x.contiguous())
    dist.broadcast(buf, src=world.members[names][0],
                   group=world.groups[names])
    out = _back(world, buf, x.device)
    if out.data_ptr() != x.data_ptr():
        x.copy_(out)
    return x


# ---------------------------------------------------------------------------
# a rank's block of a global tensor
# ---------------------------------------------------------------------------

def _spec_parts(spec, dim: int) -> int:
    return spec.part(dim) if isinstance(spec, PartitionSpec) else 1


def block_slices(shape: Sequence[int], spec: Sequence[AxisVal],
                 mesh) -> Tuple[Any, ...]:
    """This rank's block of a global ``shape`` laid out by ``spec``: a dim
    split over a tuple of axes is split row-major over them, in the spec's
    order (``P(("data", "model"))``: data-major). A dim of ``parts > 1``
    pieces (:class:`PartitionSpec`) gives the list of its indices: this
    rank's block of each piece, piece after piece; every other dim a
    slice."""
    out = []
    for i, size in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        n, idx = 1, 0
        for a in norm_axes(entry):
            c = mesh.world.coords[a] if mesh.world is not None else 0
            idx, n = idx * mesh.shape[a] + c, n * mesh.shape[a]
        parts = _spec_parts(spec, i)
        if size % (n * parts):
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{n} ways by {tuple(spec)} in {parts} parts")
        b = size // (n * parts)
        if parts == 1:
            out.append(slice(idx * b, (idx + 1) * b))
        else:
            piece = size // parts
            out.append([k * piece + idx * b + j for k in range(parts)
                        for j in range(b)])
    return tuple(out)


def block_extent(s) -> int:
    """The length of one dim's entry of :func:`block_slices`."""
    return s.stop - s.start if isinstance(s, slice) else len(s)


def local_slice(x, spec: Sequence[AxisVal], mesh):
    """This rank's block of the global ``x`` (a tensor or numpy array; a
    view where every dim's block is a slice)."""
    return x[block_slices(x.shape, spec, mesh)]


def rank_rows(tree, mesh, batch_rule, num_microbatches: int = 1):
    """This rank's rows of a tree of global batch arrays (leading dim):
    a block per pod when the rule has ``pod``, then each microbatch's
    rows split over the rule's other axes (row-major in its order), in
    storage of their own, as a rank holds them (never a view of the global
    batch, whose storage a count would charge to the rank). The whole tree
    without a world."""
    axes = tuple(a for a in norm_axes(batch_rule) if a in mesh.shape)
    if mesh.world is None or not axes:
        return tree
    inner = tuple(a for a in axes if a != "pod")

    def rows(x):
        if "pod" in axes:
            x = x[block_slices(x.shape[:1], ("pod",), mesh)]
        m = x.view(num_microbatches, -1, *x.shape[1:])
        m = m[(slice(None),) + block_slices(m.shape[1:2], (inner,), mesh)]
        return m.reshape(-1, *x.shape[1:]).clone(
            memory_format=torch.contiguous_format)

    return {k: rows(v) for k, v in tree.items()}


def gather_dim(x: torch.Tensor, axes: AxisVal, dim: int, *, parts: int = 1,
               mesh=None) -> torch.Tensor:
    """Dim ``dim`` of ``x`` whole over ``axes``: the ranks' blocks gathered
    in rank order and, where the dim is ``parts`` pieces, put back piece
    by piece (each rank's block holds its share of every piece)."""
    names = norm_axes(axes)
    for a in reversed(names):
        x = all_gather(x, a, dim=dim, mesh=mesh)
    n = _mesh_of(mesh).size(names) if names else 1
    if parts > 1 and n > 1:
        b = x.shape[dim] // (n * parts)
        x = x.unflatten(dim, (n, parts, b)).transpose(dim, dim + 1) \
             .flatten(dim, dim + 2)
    return x


def gather_global(x: torch.Tensor, spec: Sequence[AxisVal],
                  mesh) -> torch.Tensor:
    """The global tensor from each rank's block ``x`` (every rank gets
    it); the inverse of :func:`local_slice`."""
    for i, entry in enumerate(spec):
        x = gather_dim(x, entry, i, parts=_spec_parts(spec, i), mesh=mesh)
    return x
