"""Checkpoints in the reference's format (port of
``repro.checkpoint.checkpointer``).

One directory per step, ``step_%08d``, holding one ``.npz`` per tree and a
``manifest.json`` that lists each leaf's path (``"m/layers/attn/wq"``, the
paths ``jax.tree_util.tree_flatten_with_path`` gives the reference's
trees), its key in the ``.npz``, its shape and its logical dtype. bf16
(numpy has none) is stored as its raw ``uint16`` bits under the logical
name ``bfloat16`` and comes back through a torch ``view``, so no value is
rounded either way, and a checkpoint written by either package restores
bit for bit in the other.

Writes are atomic: a temporary directory, then ``os.replace``; a step
counts only once its manifest is in place, and ``restore`` reads the step
it is given. A restore may land on another device or dtype than the save
(the target tree says which)."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten_like

_NPZ_SAFE = {"float64", "float32", "float16", "int64", "int32", "int16",
             "int8", "uint64", "uint32", "uint16", "uint8", "bool"}


def _to_numpy(leaf):
    """A leaf as (numpy array as stored, logical dtype name)."""
    t = torch.as_tensor(leaf).detach().cpu()
    logical = str(t.dtype).replace("torch.", "")
    if logical in _NPZ_SAFE:
        return t.numpy(), logical
    if t.dtype != torch.bfloat16:
        raise TypeError(f"checkpoint: no storage for dtype {t.dtype}")
    # raw bits; a 0-d leaf is stored as [1], as the reference stores it
    bits = t.reshape(t.shape or (1,)).view(torch.int16).numpy()
    return bits.view(np.uint16), logical


def _from_numpy(arr: np.ndarray, meta: Dict[str, Any]) -> torch.Tensor:
    if meta["dtype"] in _NPZ_SAFE:
        return torch.from_numpy(np.array(arr))
    if meta["dtype"] != "bfloat16":
        raise TypeError(f"checkpoint: no restore for dtype {meta['dtype']}")
    bits = torch.from_numpy(np.array(arr).view(np.int16))
    return bits.view(torch.bfloat16).reshape(meta["shape"])


class Checkpointer:
    def __init__(self, directory: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, trees: Dict[str, Any]) -> None:
        """trees: e.g. ``{"params": ..., "opt": ...}``."""
        tmp = self.dir / f".tmp_step_{step:08d}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: Dict[str, Any] = {"step": step, "trees": {}}
        for name, tree in trees.items():
            arrays = {}
            meta: List[Dict[str, Any]] = []
            for i, (path, leaf) in enumerate(flatten_with_paths(tree)):
                arr, logical = _to_numpy(leaf)
                key = f"a{i}"
                arrays[key] = arr
                meta.append({"path": path, "key": key,
                             "shape": list(arr.shape), "dtype": logical})
            np.savez(tmp / f"{name}.npz", **arrays)
            manifest["trees"][name] = meta
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    def steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, name: str, target):
        """Tree ``name`` at ``step``, in ``target``'s structure: each leaf
        on the target leaf's device and in its dtype (tensors, or anything
        with ``shape``, ``dtype`` and ``device``)."""
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / f"{name}.npz") as data:
            by_path = {m["path"]: _from_numpy(data[m["key"]], m)
                       for m in manifest["trees"][name]}
        pairs = flatten_with_paths(target)
        out = []
        for path, leaf in pairs:
            if path not in by_path:
                raise KeyError(f"checkpoint missing leaf {path!r}")
            t = by_path[path]
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {path}: ckpt "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            out.append(t.to(device=leaf.device, dtype=leaf.dtype))
        return unflatten_like(target, out)
