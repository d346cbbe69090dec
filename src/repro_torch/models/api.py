"""Uniform model API: every architecture builds to a :class:`Model` with the
same entry points, so the serving engine treats them alike (Clipper's model
container narrow waist, paper §4.4, at the model-definition level).

Entry points run on the card unless the caller asks for the CPU: ``device``
defaults to ``"cuda"`` and raises when no card is present; it never falls
back to the CPU. ``build_model(device="meta")`` builds a model of shapes
only, which computes nothing (the launch tooling's dry run counts it)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype
    init: Callable[..., Any]          # torch.Generator -> params
    prefill: Callable[..., Any]       # (params, batch, max_len)
    #                                   -> (logits, cache)
    decode_step: Callable[..., Any]   # (params, cache, tokens, lengths)
    #                                   -> (logits, cache)
    init_cache: Callable[..., Any]    # (batch, max_len) -> cache
    loss_fn: Callable[..., Any]       # (params, batch) -> fp32 scalar
    #                                   (differentiable; runs no kernel)
    extras: Dict[str, Any] = field(default_factory=dict)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def tp_of(mesh) -> int:
    """The mesh's ``model`` size, by which heads and vocab are padded."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


def build_model(cfg: ModelConfig, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16, remat: str = "full",
                mesh=None, rules=None, **opts) -> Model:
    """Dispatch on family: the decoder-only transformer (dense, moe, vlm),
    xlstm (ssm), hymba (hybrid) and the encoder-decoder (encdec).

    ``remat`` is ``loss_fn``'s activation checkpointing around each layer
    (``"full"``, ``"dots"`` or ``"none"``; ``common.with_remat``).

    ``mesh`` (``launch.mesh`` over a ``torch.distributed`` world) and
    ``rules`` (``distributed.sharding``'s tables) build this rank's model,
    on the mesh's device: heads and vocab padded by ``cfg.padded(tp)`` in
    every family, and every family's leaves placed by the reference's
    logical axes (``common.Placement``: dense tensor parallel over
    ``model``, ``fsdp`` over ``data`` where the rules say so); the
    transformer families also run their moe layers expert parallel and
    their prefill context parallel where the rules say so. Without a
    mesh, one device, as always."""
    from repro_torch.models import encdec, hymba, transformer, xlstm

    if (mesh is not None and mesh.world is not None
            and torch.device(device).type != "meta"):
        device = mesh.world.device
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    if mesh is not None:
        opts.update(mesh=mesh, rules=rules)
    modules = {"dense": transformer, "moe": transformer, "vlm": transformer,
               "ssm": xlstm, "hybrid": hymba, "encdec": encdec}
    if cfg.family in modules:
        return modules[cfg.family].build(cfg, device=dev, dtype=dtype,
                                         remat=remat, **opts)
    raise ValueError(f"unknown family {cfg.family!r}")
