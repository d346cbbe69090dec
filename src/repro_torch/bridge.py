"""Parameters from the JAX package into the port, bit for bit.

Input: the reference's parameter tree as a nested dict of numpy arrays (what
``jax.tree.map(np.asarray, params)`` gives). Output: the same tree of torch
tensors on ``device``. Layouts are kept as they are: weights ``[in, out]``
(the port computes ``x @ w``), layer leaves stacked on a leading ``[L]``
axis. bf16 arrays (numpy dtype ``bfloat16`` from ``ml_dtypes``) travel as
their raw 16-bit patterns through a ``uint16`` view and come out with
``.view(torch.bfloat16)``, so no value is rounded on the way.

Like every entry point of the port, the bridge puts its tensors on the card
unless the caller asks for the CPU: ``device`` defaults to ``"cuda"``,
raises when no card is present, and never falls back."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.api import resolve_device


def tensor_from_numpy(a: np.ndarray, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dev = resolve_device(device)
    a = np.array(a, order="C")          # a writable copy for torch to own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(dev)


def params_from_numpy(tree: Any, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of numpy arrays -> the same nested dict of tensors."""
    resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device, dtype)




def params_for_rank(tree: Any, model, mesh=None, dtype=None) -> Any:
    """This rank's shards of a one-device params tree for ``model`` built
    on ``mesh`` (default: the model's). Each leaf the model places by a
    logical axis (``extras["param_specs"]``: the expert dim over
    ``model``; ``expert_ffn`` over ``data`` in ``ep2d``; the ``fsdp``
    storage dim in gather mode) is cut to this rank's block, the rest
    arrive whole. Numpy leaves (the reference's params) are cut before
    they leave numpy and arrive on the model's device, bf16 bit-exact as
    in :func:`params_from_numpy`; tensor leaves stay where they are, their
    blocks views, so ranks that share a card and were handed one copy of
    the weights (``launch.mesh.run_ranks`` passes CUDA tensors as handles
    to the same memory) add no copy of their own."""
    from repro_torch.distributed.sharding import local_slice
    from repro_torch.tree import flatten_with_paths, unflatten_like

    mesh = mesh if mesh is not None else model.extras.get("mesh")
    specs = model.extras.get("param_specs", {})
    flat = []
    for path, leaf in flatten_with_paths(tree):
        if path in specs:
            leaf = local_slice(leaf, specs[path], mesh)
        if not isinstance(leaf, torch.Tensor):
            leaf = tensor_from_numpy(np.asarray(leaf), model.device, dtype)
        flat.append(leaf)
    return unflatten_like(tree, flat)
