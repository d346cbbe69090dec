"""Device meshes (port of ``repro.launch.mesh``).

A :class:`Mesh` is an ordered mapping of axis names to sizes and the
devices it spans. Without a ``torch.distributed`` world a mesh spans one
device, as it always did: the meshes that compute span one device and the
production meshes keep their shapes with no devices, for the sharding
rules (``repro_torch.launch.steps.rules_for``, ``fit_batch_sharding``),
which read nothing else.

With an initialised world a mesh spans its ranks, one process a rank, laid
out in the reference's row-major device order: rank ``r`` sits at the
coordinates ``np.unravel_index(r, shape)``. Its :class:`World` holds the
rank's coordinates, its device, and one process group for every set of
axes (``("model",)``, ``("data", "model")``, ...), whose members are the
ranks that differ only along those axes. ``repro_torch.distributed.
sharding``'s collectives run on those groups.

Two transports, chosen by how the mesh is laid out and never by a failure:
NCCL when every rank has a card of its own (one rank per card, the
production layout), gloo when the ranks run on the CPU or when the caller
asks for ranks to share a card (``share=True``: the tests and
``chip_smoke.py`` on one card, the counterpart of the reference's
``--xla_force_host_platform_device_count``). gloo does not compute on
card memory, so under sharing every collective copies through host memory,
and the bytes it stages are counted. Without ``share`` a mesh with more
ranks than cards raises.

:func:`run_ranks` starts a world of spawned processes on one host and
joins it with a deadline: a rank that fails fails the call with its
traceback, and a world that hangs is killed.

A counting rank (:func:`make_rank_mesh`) is one rank of a mesh on the
meta device, with no world at all: its collectives are recorded and not
run, so one process counts a rank of the production meshes, 256 or 512
ranks, that no host could start.

A mesh names its devices without touching them, so importing this module
touches no device."""

from __future__ import annotations

import itertools
import os
import queue as queue_lib
import tempfile
import time
import traceback
from collections import defaultdict
from dataclasses import dataclass, field
from datetime import timedelta
from pathlib import Path
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

# a collective that waits longer than this fails, on every world
WORLD_TIMEOUT_S = 60


class CollectiveRecord:
    """Per (op, axes, dtype): calls and payload bytes (the tensor each rank
    hands the collective), and the bytes copied through host memory where
    the transport cannot read card memory."""

    def __init__(self):
        self.calls: Dict[Tuple[str, Tuple[str, ...], str], int] = \
            defaultdict(int)
        self.bytes: Dict[Tuple[str, Tuple[str, ...], str], int] = \
            defaultdict(int)
        self.staged_bytes = 0

    def add(self, op: str, axes: Tuple[str, ...], t: torch.Tensor) -> None:
        key = (op, axes, str(t.dtype).replace("torch.", ""))
        self.calls[key] += 1
        self.bytes[key] += t.numel() * t.element_size()

    def clear(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.staged_bytes = 0

    def summary(self) -> List[Dict[str, Any]]:
        """One entry per (op, axes, dtype), sorted."""
        return [{"op": op, "axes": list(axes), "dtype": dt,
                 "calls": self.calls[(op, axes, dt)],
                 "bytes": self.bytes[(op, axes, dt)]}
                for op, axes, dt in sorted(self.calls)]


@dataclass
class World:
    """This rank's place in a mesh over a ``torch.distributed`` world."""
    rank: int
    coords: Dict[str, int]
    device: torch.device
    backend: str                         # "nccl", "gloo" or "count"
    staged: bool                                   # copies through the host
    groups: Dict[Tuple[str, ...], Any]             # axes -> ProcessGroup
    members: Dict[Tuple[str, ...], Tuple[int, ...]]  # axes -> global ranks
    record: CollectiveRecord = field(default_factory=CollectiveRecord)


@dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]                 # axis name -> size, in order
    devices: Tuple[torch.device, ...] = field(default=())
    world: Optional[World] = field(default=None, compare=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (a name or a tuple of names) in the mesh's order, those
        the mesh has."""
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        return tuple(a for a in self.shape if a in names)

    def size(self, axes) -> int:
        n = 1
        for a in self.axes(axes):
            n *= self.shape[a]
        return n

    def index(self, axes) -> int:
        """This rank's linear index along ``axes`` (row-major over them, in
        the mesh's order); 0 without a world."""
        idx = 0
        for a in self.axes(axes):
            c = self.world.coords[a] if self.world is not None else 0
            idx = idx * self.shape[a] + c
        return idx


def _devices(device) -> Tuple[torch.device, ...]:
    """Every device of ``device``'s type: the visible cards for ``"cuda"``
    (raising without one, as the port's entry points do), one otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,)
    from repro_torch.models.api import resolve_device
    resolve_device(dev)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def _world_device(device, rank: int, share: bool, n: int) -> torch.device:
    """The device of ``rank`` in a world of ``n`` ranks: the CPU, the
    rank's own card (``LOCAL_RANK``, as ``torch.distributed.run`` sets it),
    or with ``share`` a card shared round-robin."""
    devs = _devices(device)
    if torch.device(device).type != "cuda":
        return devs[0]
    if share:
        return devs[rank % len(devs)]
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))   # ranks on this host
    if local > len(devs):
        raise ValueError(f"{local} ranks on this host need {local} cards; "
                         f"{len(devs)} are visible (pass share=True to run "
                         f"ranks on a shared card)")
    return devs[int(os.environ.get("LOCAL_RANK", rank))]


def mesh_groups(shape: Sequence[int], axes: Sequence[str]
                ) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """Every process group of a mesh laid out row-major, as (the axes it
    spans, its global ranks in rank order): for each set of axes in one
    order, one group for every choice of the other axes' coordinates."""
    grid = np.arange(int(np.prod(shape))).reshape(tuple(shape))
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            keep = [i for i in range(len(axes)) if i not in sub]
            moved = np.moveaxis(grid, keep, list(range(len(keep))))
            for fixed in itertools.product(*(range(shape[i]) for i in keep)):
                yield (tuple(axes[i] for i in sub),
                       tuple(int(r) for r in moved[fixed].reshape(-1)))


def _world_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device,
                share: bool) -> Mesh:
    import torch.distributed as dist

    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs a world of {n} ranks; this "
                         f"world has {dist.get_world_size()}")
    rank = dist.get_rank()
    dev = _world_device(device, rank, share, n)
    backend = "nccl" if dev.type == "cuda" and not share else "gloo"
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    groups, members = {}, {}
    # every rank creates every group, in one order, as torch.distributed
    # requires; a rank keeps the groups it belongs to
    for names, ranks in mesh_groups(shape, axes):
        g = dist.new_group(list(ranks), backend=backend,
                           timeout=timedelta(seconds=WORLD_TIMEOUT_S))
        if rank in ranks:
            groups[names], members[names] = g, ranks
    world = World(rank=rank, coords=coords, device=dev, backend=backend,
                  staged=share and dev.type == "cuda", groups=groups,
                  members=members)
    return Mesh(dict(zip(axes, shape)), (dev,), world)


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device,
          share: bool = False) -> Mesh:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return _world_mesh(shape, axes, device, share)
    devs = _devices(device)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"a {shape} mesh needs {n} devices; "
                         f"{len(devs)} {torch.device(device).type} "
                         f"device(s) are visible")
    return Mesh(dict(zip(axes, shape)), devs[:n])


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device="cuda",
              share: bool = False) -> Mesh:
    """A mesh of any axes (``("pod", "data", "model")``, ...) over the
    world when one is initialised, else over the visible devices."""
    return _mesh(tuple(shape), tuple(axes), device, share)


# the reference's production meshes (``repro.launch.mesh.
# make_production_mesh``), by the dry run's name for each
PRODUCTION = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, (16, 16) or (2, 16, 16), with no
    devices: for the sharding rules only."""
    return Mesh(dict(PRODUCTION["multi" if multi_pod else "single"]))


def make_rank_mesh(shape: Sequence[int], axes: Sequence[str],
                   coords: Dict[str, int]) -> Mesh:
    """One counting rank of a (``shape``, ``axes``) mesh, at ``coords``, on
    the meta device: a :class:`World` of backend ``"count"`` with the
    rank's coordinates and its groups' members but no process group.
    ``distributed.sharding``'s collectives record each call on its
    ``record`` as a real world's do and return empty tensors of the shapes
    the real collective returns, so a rank's step (``launch.steps``) runs
    and is counted (``launch.hlo_stats.count``) without the other ranks
    and without ``torch.distributed``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if set(coords) != set(axes) or any(
            not 0 <= coords[a] < n for a, n in zip(axes, shape)):
        raise ValueError(f"coordinates {coords} are not a rank of "
                         f"{dict(zip(axes, shape))}")
    rank = int(np.ravel_multi_index([coords[a] for a in axes], shape))
    members = {names: ranks for names, ranks in mesh_groups(shape, axes)
               if rank in ranks}
    meta = torch.device("meta")
    world = World(rank=rank, coords={a: int(coords[a]) for a in axes},
                  device=meta, backend="count", staged=False, groups={},
                  members=members)
    return Mesh(dict(zip(axes, shape)), (meta,), world)


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda",
                    share: bool = False) -> Mesh:
    """A (data, model) mesh: over the world's ranks when
    ``torch.distributed`` is initialised, else over the first ``data *
    model`` devices of ``device``'s type (the card by default; ``"cpu"``
    and ``"meta"`` have one)."""
    return _mesh((data, model), ("data", "model"), device, share)


def make_elastic_mesh(model_parallelism: int = 16, *, device="cuda",
                      share: bool = False) -> Mesh:
    """The largest (data, model) mesh the world's ranks, or without a
    world the visible devices, support — elastic scaling: the same
    launcher works at any device count. One card and no world gives
    (1, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
    else:
        n = len(_devices(device))
    model = min(model_parallelism, n)
    while n % model:
        model -= 1
    return _mesh((n // model, model), ("data", "model"), device, share)


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

def init_world(rank: int, world_size: int, init_method: str, *,
               device="cuda", share: bool = False) -> None:
    """Join a world: NCCL when each rank has its own card, gloo on the CPU
    or on a shared card; every collective fails after
    ``WORLD_TIMEOUT_S``."""
    import torch.distributed as dist

    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" and not share else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_world_device(dev, rank, share, world_size))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=WORLD_TIMEOUT_S))


def init_world_from_env(device="cuda") -> bool:
    """Join the world ``python -m torch.distributed.run`` describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), one rank
    per card; False, doing nothing, when no launcher set them."""
    if "WORLD_SIZE" not in os.environ:
        return False
    init_world(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
               "env://", device=device)
    return True


def _rank_main(fn, rank, nranks, init_method, device, share, args, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        init_world(rank, nranks, init_method, device=device, share=share)
        out.put((rank, True, fn(rank, *args)))
    except BaseException:                            # reported, then re-raised
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, nranks: int, *args, device="cuda",
              share: bool = False, timeout: float = 120.0,
              tmpdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nranks`` spawned processes joined in one
    world (``init_world``; a ``file://`` rendezvous in ``tmpdir``, so
    worlds started side by side never meet) -> each rank's return value,
    by rank. The ranks run on the card unless ``device`` asks for the CPU
    (``"cuda"`` raises without one, before a rank starts). ``fn`` and
    ``args`` are pickled (CUDA tensors travel as handles to the same
    memory). A rank that raises or dies fails the call with its
    traceback; ranks still running ``timeout`` seconds after the start, or
    a few seconds after another rank failed, are killed."""
    from repro_torch.models.api import resolve_device

    resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=tmpdir) as d:
        init = Path(d, "rendezvous").as_uri()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, nranks, init, str(device), share,
                                   args, out))
                 for r in range(nranks)]
        for p in procs:
            p.start()
        results: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        deadline = time.monotonic() + timeout
        failed_at = None
        try:
            while len(results) + len(errors) < nranks:
                now = time.monotonic()
                if now > deadline or (failed_at and now > failed_at + 5):
                    break
                try:
                    rank, ok, val = out.get(timeout=0.2)
                except queue_lib.Empty:
                    for r, p in enumerate(procs):
                        if (not p.is_alive() and p.exitcode
                                and r not in results and r not in errors):
                            errors[r] = f"exited with code {p.exitcode}"
                    if errors and failed_at is None:
                        failed_at = time.monotonic()
                    continue
                (results if ok else errors)[rank] = val
                if not ok and failed_at is None:
                    failed_at = time.monotonic()
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    if errors or len(results) < nranks:
        late = [r for r in range(nranks) if r not in results
                and r not in errors]
        msg = [f"rank {r} failed:\n{errors[r]}" for r in sorted(errors)]
        if late:
            msg.append(f"ranks {late} did not finish within {timeout} s "
                       f"(killed)")
        raise RuntimeError("\n".join(msg))
    return [results[r] for r in range(nranks)]
