"""Device meshes (port of ``repro.launch.mesh``).

A :class:`Mesh` is an ordered mapping of axis names to sizes and the
devices it spans. The port runs on one device, so the meshes that compute
span one device; the production meshes keep their shapes with no devices,
for the sharding rules (``repro_torch.launch.steps.rules_for``,
``fit_batch_sharding``), which read nothing else. A mesh names its devices
without touching them, so importing this module touches no device."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    shape: Dict[str, int]                 # axis name -> size, in order
    devices: Tuple[torch.device, ...] = field(default=())

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)


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


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device) -> Mesh:
    devs = _devices(device)
    n = 1
    for s in shape:
        n *= s
    if n > len(devs):
        raise ValueError(f"a {shape} mesh needs {n} devices; "
                         f"{len(devs)} {torch.device(device).type} "
                         f"device(s) are visible")
    return Mesh(dict(zip(axes, shape)), devs[:n])


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, (16, 16) or (2, 16, 16), with no
    devices: for the sharding rules only."""
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device="cuda") -> Mesh:
    """A (data, model) mesh over the first ``data * model`` devices of
    ``device``'s type (the card by default; ``"cpu"`` and ``"meta"`` have
    one)."""
    return _mesh((data, model), ("data", "model"), device)


def make_elastic_mesh(model_parallelism: int = 16, *,
                      device="cuda") -> Mesh:
    """The largest (data, model) mesh the visible devices support —
    elastic scaling: the same launcher works at any device count. One card
    gives (1, 1)."""
    n = len(_devices(device))
    model = min(model_parallelism, n)
    while n % model:
        model -= 1
    return _mesh((n // model, model), ("data", "model"), device)
