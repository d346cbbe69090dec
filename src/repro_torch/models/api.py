"""Uniform model API: every architecture builds to a :class:`Model` with the
same entry points, so the serving engine treats them alike (Clipper's model
container narrow waist, paper §4.4, at the model-definition level).

Entry points run on the card unless the caller asks for the CPU: ``device``
defaults to ``"cuda"`` and raises when no card is present; it never falls
back to the CPU."""

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


def build_model(cfg: ModelConfig, *, device="cuda",
                dtype: torch.dtype = torch.bfloat16, **opts) -> Model:
    """Dispatch on family: the decoder-only transformer (dense, moe, vlm),
    xlstm (ssm), hymba (hybrid) and the encoder-decoder (encdec)."""
    from repro_torch.models import encdec, hymba, transformer, xlstm

    dev = resolve_device(device)
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer.build(cfg, device=dev, dtype=dtype, **opts)
    if cfg.family == "ssm":
        return xlstm.build(cfg, device=dev, dtype=dtype, **opts)
    if cfg.family == "hybrid":
        return hymba.build(cfg, device=dev, dtype=dtype, **opts)
    if cfg.family == "encdec":
        return encdec.build(cfg, device=dev, dtype=dtype, **opts)
    raise ValueError(f"unknown family {cfg.family!r}")
