"""Meta-tensor stand-ins for every model input (port of
``repro.launch.inputs``): the dry run counts steps on these (shapes and
dtypes, no memory), and :func:`make_concrete` fills them with the
reference's numbers.

For modality-stub archs (vlm/audio) the frontend output arrives as
precomputed embeddings per DESIGN.md §4."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec

I32 = torch.int32
F32 = torch.float32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        S_dec = S // cfg.decoder_ratio
        return {
            "frames": _sds((B, S, cfg.d_model), F32),
            "tokens": _sds((B, S_dec), I32),
            "labels": _sds((B, S_dec), I32),
        }
    if cfg.frontend == "vision":
        P = cfg.num_prefix_embeddings
        S_text = S - P
        return {
            "prefix_embeddings": _sds((B, P, cfg.d_model), F32),
            "tokens": _sds((B, S_text), I32),
            "labels": _sds((B, S_text), I32),
        }
    return {"tokens": _sds((B, S), I32), "labels": _sds((B, S), I32)}


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    b = train_batch_specs(cfg, shape)
    b.pop("labels", None)
    return b


def decode_input_specs(cfg: ModelConfig,
                       shape: ShapeSpec) -> Tuple[Any, Any]:
    """(tokens [B,1], lengths [B]) for serve_decode."""
    B = shape.global_batch
    return _sds((B, 1), I32), _sds((B,), I32)


def batch_axes_tree(batch_specs: Dict[str, Any]):
    """Logical axes for each batch input (batch dim sharded, rest replicated)."""
    out = {}
    for k, v in batch_specs.items():
        out[k] = ("batch",) + (None,) * (len(v.shape) - 1)
    return out


def make_concrete(batch_specs: Dict[str, Any], rng=None, vocab: int = 1000,
                  *, device="cuda") -> Dict[str, torch.Tensor]:
    """Concrete batches on ``device``: the reference's numbers, drawn in
    the same order from ``numpy.random.default_rng(0)`` (``rng`` is
    ignored, as there): int32 tokens in ``[0, vocab)``, fp32 ``N(0, 1) *
    0.02`` elsewhere."""
    from repro_torch.models.api import resolve_device

    dev = resolve_device(device)
    r = np.random.default_rng(0)
    out = {}
    for k, v in batch_specs.items():
        shape = tuple(v.shape)
        if v.dtype == I32:
            a = r.integers(0, vocab, shape).astype(np.int32)
        else:
            a = (r.normal(size=shape) * 0.02).astype(np.float32)
        out[k] = torch.from_numpy(a).to(dev)
    return out
