"""Model FLOPs and the bytes a decode step must read, from a configuration.

The count is the benchmark's own, from the published shapes (the vocab as
published, not padded): 2 operations per weight of a matrix product a
token touches (dbrx: its ``top_k`` experts), attention's q k and p v over
the positions each token sees (4 D operations a pair and query head), and
for hymba's SSD heads the recurrent form's state update and read (4
operations per state element a token). Peaks: NVIDIA's data sheet for the
H100 SXM, dense, at 700 W."""

from __future__ import annotations

from typing import Dict, Iterable

PEAK_BF16 = 989e12          # FLOP/s
PEAK_F32 = 67e12            # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12        # bytes/s of HBM3


def _dims(cfg: Dict):
    d, nq, nkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    return d, nq, nkv, d // nq


def matmul_params_per_token(family: str, cfg: Dict) -> int:
    """Weights of the matrix products one token runs through."""
    d, nq, nkv, hd = _dims(cfg)
    attn = d * nq * hd * 2 + d * nkv * hd * 2
    head = d * cfg["vocab_size"]
    if family == "hybrid":
        nh, ds = nq, cfg["ssm_state"]
        di = nh * hd
        ssd = d * 2 * di + d * 2 * nh * ds + d * nh + di * d
        ffn = 3 * d * cfg["d_ff"]
        return cfg["num_layers"] * (attn + ssd + ffn) + head
    if family == "moe":
        ffn = cfg["num_experts_per_tok"] * 3 * d * cfg["d_ff"]
        router = d * cfg["num_experts"]
        return cfg["num_layers"] * (attn + ffn + router) + head
    raise ValueError(family)


def weight_bytes(family: str, cfg: Dict, itemsize: int = 2) -> int:
    """Bytes of every weight a decode step reads once (the embedding's
    rows aside): all experts, since a batch's picks leave none unread."""
    d, nq, nkv, hd = _dims(cfg)
    attn = (d * nq * hd * 2 + d * nkv * hd * 2) * itemsize
    head = d * cfg["vocab_size"] * itemsize
    if family == "hybrid":
        nh, ds = nq, cfg["ssm_state"]
        di = nh * hd
        ssd = ((d * 2 * di + d * 2 * nh * ds + di * d
                + cfg["conv_width"] * di) * itemsize + (d * nh + 3 * nh) * 4)
        ffn = 3 * d * cfg["d_ff"] * itemsize
        norms = 4 * d * itemsize
        return cfg["num_layers"] * (attn + ssd + ffn + norms) + head \
            + d * itemsize
    if family == "moe":
        ffn = cfg["num_experts"] * 3 * d * cfg["d_ff"] * itemsize
        router = d * cfg["num_experts"] * 4
        norms = 2 * d * itemsize
        return cfg["num_layers"] * (attn + ffn + router + norms) + head \
            + d * itemsize
    raise ValueError(family)


def _seen(family: str, cfg: Dict, pos: int, global_layer: bool) -> int:
    """Positions a token at ``pos`` attends in one layer."""
    if family == "hybrid" and not global_layer:
        return min(pos + 1, cfg["window"])
    return pos + 1


def _layers(family: str, cfg: Dict):
    """(count, global) of the layers by kind."""
    if family == "hybrid":
        g = len(cfg["global_layers"])
        return ((g, True), (cfg["num_layers"] - g, False))
    return ((cfg["num_layers"], True),)


def token_flops(family: str, cfg: Dict, pos: int) -> float:
    """Model FLOPs of one token at position ``pos`` (0-based)."""
    d, nq, nkv, hd = _dims(cfg)
    f = 2.0 * matmul_params_per_token(family, cfg)
    for n, glob in _layers(family, cfg):
        f += n * 4.0 * nq * hd * _seen(family, cfg, pos, glob)
    if family == "hybrid":
        f += cfg["num_layers"] * 4.0 * nq * cfg["ssm_state"] * hd
    return f


def prompt_flops(family: str, cfg: Dict, length: int) -> float:
    """Model FLOPs of a prompt of ``length`` tokens."""
    d, nq, nkv, hd = _dims(cfg)
    f = 2.0 * matmul_params_per_token(family, cfg) * length
    for n, glob in _layers(family, cfg):
        w = cfg["window"] if family == "hybrid" and not glob else 0
        if w and length > w:
            pairs = w * (w + 1) // 2 + (length - w) * w
        else:
            pairs = length * (length + 1) // 2
        f += n * 4.0 * nq * hd * pairs
    if family == "hybrid":
        f += cfg["num_layers"] * 4.0 * nq * cfg["ssm_state"] * hd * length
    return f


def decode_step_bytes(family: str, cfg: Dict, positions: Iterable[int],
                      itemsize: int = 2) -> float:
    """Bytes one decode step must read for the active slots whose current
    tokens sit at ``positions``: every weight once, each slot's K and V of
    the positions it attends, and hymba's SSD and conv states (read and
    written)."""
    d, nq, nkv, hd = _dims(cfg)
    total = float(weight_bytes(family, cfg, itemsize))
    for p in positions:
        for n, glob in _layers(family, cfg):
            total += n * 2 * _seen(family, cfg, p, glob) * nkv * hd * itemsize
        if family == "hybrid":
            total += cfg["num_layers"] * 2 * (
                nq * cfg["ssm_state"] * hd * 4
                + (cfg["conv_width"] - 1) * nq * hd * itemsize)
    return total
