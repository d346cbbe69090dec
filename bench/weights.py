"""Weights made from the seed, on the device, in the type they are served
in: the tree that both the program and the reference are handed.

Each leaf of normally drawn weights comes from one call of ``torch.randn``
on a generator of the device, scaled by ``1 / sqrt(fan_in)`` in place (the
embedding by 1); a stacked leaf ``[L, ...]`` is one call for all its
layers. Norm weights are ones. The SSD branch's step-size bias, decay and
skip are drawn as Mamba-2 initialises them (dt log-uniform on [0.001, 0.1],
A uniform on [1, 16], D = 1), so that some heads remember across chunks.

The tree's layout is the program's: ``tree_specs`` lists every leaf by
path, shape, dtype and how it is drawn, and a CPU test holds it against
the program's own ``init`` at a small size."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# (shape, kind, fan_in, float32): kind "normal", "ones", or a named draw
Leaf = Tuple[Tuple[int, ...], str, int, bool]


def _padded_vocab(cfg: Dict) -> int:
    return -(-cfg["vocab_size"] // 256) * 256


def _embed(cfg: Dict) -> Dict[str, Leaf]:
    V, d = _padded_vocab(cfg), cfg["d_model"]
    return {"embedding": ((V, d), "normal", 1, False),
            "head": ((d, V), "normal", d, False),
            "final_norm": ((d,), "ones", 0, False)}


def _attn(cfg: Dict) -> Dict[str, Leaf]:
    d, nq, nkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // nq
    return {"wq": ((d, nq * hd), "normal", d, False),
            "wk": ((d, nkv * hd), "normal", d, False),
            "wv": ((d, nkv * hd), "normal", d, False),
            "wo": ((nq * hd, d), "normal", nq * hd, False)}


def _glu(d: int, dff: int) -> Dict[str, Leaf]:
    return {"wi": ((d, dff), "normal", d, False),
            "wg": ((d, dff), "normal", d, False),
            "wo": ((dff, d), "normal", dff, False)}


def _stacked(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stacked(v, n) for k, v in tree.items()}
    shape, kind, fan, f32 = tree
    return ((n,) + shape, kind, fan, f32)


def tree_specs(family: str, cfg: Dict):
    """Every leaf of the served tree of a ``family`` model (``"hybrid"``:
    hymba; ``"moe"``: the decoder-only transformer with experts)."""
    d = cfg["d_model"]
    if family == "hybrid":
        nh, ds, cw = cfg["num_heads"], cfg["ssm_state"], cfg["conv_width"]
        di = d                                   # heads * head size
        layer = {
            "ln": ((d,), "ones", 0, False), "attn": _attn(cfg),
            "ssd": {"w_in": ((d, 2 * di), "normal", d, False),
                    "conv": ((cw, di), "normal", cw, False),
                    "w_bc": ((d, 2 * nh * ds), "normal", d, False),
                    "w_dt": ((d, nh), "normal", d, True),
                    "b_dt": ((nh,), "dt_bias", 0, True),
                    "a_log": ((nh,), "a_log", 0, True),
                    "d_skip": ((nh,), "ones", 0, True),
                    "w_out": ((di, d), "normal", di, False)},
            "ln_attn": ((d,), "ones", 0, False),
            "ln_ssd": ((d,), "ones", 0, False),
            "ln2": ((d,), "ones", 0, False),
            "ffn": _glu(d, cfg["d_ff"]),
        }
        ng = len(cfg["global_layers"])
        return {"embed": _embed(cfg), "g": _stacked(layer, ng),
                "swa": _stacked(layer, cfg["num_layers"] - ng)}
    if family == "moe":
        E, dff = cfg["num_experts"], cfg["d_ff"]
        layer = {
            "ln1": ((d,), "ones", 0, False), "attn": _attn(cfg),
            "ln2": ((d,), "ones", 0, False),
            "moe": {"router": ((d, E), "normal", d, True),
                    "wi": ((E, d, dff), "normal", d, False),
                    "wg": ((E, d, dff), "normal", d, False),
                    "wo": ((E, dff, d), "normal", dff, False)},
        }
        return {"embed": _embed(cfg),
                "layers": _stacked(layer, cfg["num_layers"])}
    raise ValueError(f"no weights for family {family!r}")


def make_params(family: str, cfg: Dict, seed: int, device,
                dtype: torch.dtype = torch.bfloat16):
    """The served tree of weights, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))

    def make(tree, path=""):
        if isinstance(tree, dict):
            return {k: make(tree[k], f"{path}/{k}") for k in sorted(tree)}
        shape, kind, fan, f32 = tree
        dt = torch.float32 if f32 else dtype
        if kind == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if kind == "normal":
            x = torch.randn(shape, generator=gen, dtype=dt, device=device)
            if fan > 1:
                x.mul_(1.0 / math.sqrt(fan))
            return x
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        if kind == "dt_bias":       # softplus^-1 of dt, log-uniform
            dt_ = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
            return dt_ + torch.log(-torch.expm1(-dt_))
        if kind == "a_log":
            return torch.log(1.0 + 15.0 * u)
        raise ValueError(f"unknown draw {kind!r} at {path}")

    return make(tree_specs(family, cfg))

