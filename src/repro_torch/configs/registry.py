"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, SHAPES_BY_NAME, ShapeSpec, applicable_shapes

from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.minitron_8b import CONFIG as _minitron
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba

ARCHITECTURES: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _dbrx, _kimi, _xlstm, _granite, _qwen2,
        _smollm, _minitron, _internvl2, _seamless, _hymba,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def get_shape(name: str) -> ShapeSpec:
    if name not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {name!r}; choose from {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[name]


def reduced_config(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 64,
                   vocab_size: int = 256) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (DESIGN.md §4).

    Keeps the family, attention grouping ratios and block structure; shrinks
    widths, depth, expert count, and embedding tables.
    """
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, 2))
    while heads % kv:
        heads += 1
    updates = dict(
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 3,
        vocab_size=vocab_size,
        num_prefix_embeddings=8 if cfg.num_prefix_embeddings else 0,
        window=16 if cfg.window else 0,
        global_layers=(0,) if cfg.global_layers else (),
        ssm_state=8 if cfg.ssm_state else 0,
    )
    if cfg.num_experts:
        updates.update(num_experts=4, num_experts_per_tok=2)
    return dataclasses.replace(cfg, **updates)


def all_cells():
    """Every runnable (arch, shape) pair — 32 cells (DESIGN.md §4)."""
    for name, cfg in sorted(ARCHITECTURES.items()):
        for shape in applicable_shapes(cfg):
            yield cfg, shape
