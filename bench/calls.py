"""The least time the card could take for the logical work of each
kernel's calls in a traced run, from the frozen work counts
(``bench/frozen/work.py``) at the calls' shapes and valid positions.

A bound counts the operation the model's equations ask for, whoever
implements it: the active slots of a decode step and the valid positions of
each prompt, each prompt alone, never the padding or the idle slots that a
kernel may also compute. So a kernel that is replaced, fused or made to
skip waste is read against the same work, and a share of a bound cannot
pass 100 % unless a count is wrong."""

from __future__ import annotations

from typing import Dict, List

from bench.frozen.work import (
    Work, decode_attention_work, flash_attention_work, rmsnorm_work,
    ssd_scan_valid_work,
)
from bench.model_count import PEAK_BF16, PEAK_BYTES, PEAK_F32

SSD_CHUNK = 256         # the chunked SSD algorithm's block


def bound_s(w: Work) -> float:
    """The larger of the bytes over the bandwidth and the operations over
    their dtype's peak."""
    ops = w.flops.get("bf16", 0.0) / PEAK_BF16 + w.flops.get("f32", 0.0) \
        / PEAK_F32
    return max(w.bytes / PEAK_BYTES, ops)


def _heads(cfg: Dict):
    d, nq = cfg["d_model"], cfg["num_heads"]
    return nq, cfg["num_kv_heads"], d // nq


def attention_layers(family: str, cfg: Dict):
    """(count, windowed) of the model's attention layers by kind."""
    if family == "hybrid":
        g = len(cfg["global_layers"])
        return [(g, False), (cfg["num_layers"] - g, True)]
    return [(cfg["num_layers"], False)]


def decode_attention_bound(family: str, cfg: Dict, max_len: int,
                           positions: List[int]) -> float:
    """One decode step's attention over the active slots whose current
    tokens sit at ``positions``: full caches of ``max_len`` rows, and
    hymba's windowed layers' rings of ``window`` rows."""
    nq, nkv, hd = _heads(cfg)
    total = 0.0
    for n, windowed in attention_layers(family, cfg):
        if windowed:
            w = cfg["window"]
            lens = [min(p + 1, w) for p in positions]
            smax = w
        else:
            lens = [p + 1 for p in positions]
            smax = max_len
        total += n * bound_s(decode_attention_work(
            len(positions), nq, nkv, hd, smax, lengths=lens))
    return total


def norms_per_token(family: str, cfg: Dict) -> int:
    """RMSNorms a token passes: hymba's four a layer (the block's input,
    each branch's output, the FFN's input), the transformer's two, and the
    final one."""
    per = 4 if family == "hybrid" else 2
    return per * cfg["num_layers"] + 1


def rmsnorm_bound(family: str, cfg: Dict, rows: int) -> float:
    """The norms of ``rows`` tokens, each alone a call of ``rows`` rows."""
    return norms_per_token(family, cfg) * bound_s(
        rmsnorm_work(rows, cfg["d_model"]))


def flash_bound(family: str, cfg: Dict, lengths: List[int]) -> float:
    """A prefill's attention: each prompt alone, causal over its own
    positions, windowed on hymba's windowed layers."""
    nq, nkv, hd = _heads(cfg)
    total = 0.0
    for n, windowed in attention_layers(family, cfg):
        w = cfg["window"] if windowed else 0
        for L in lengths:
            total += n * bound_s(flash_attention_work(
                1, int(L), nq, nkv, hd, window=w))
    return total


def ssd_bound(cfg: Dict, lengths: List[int]) -> float:
    """A prefill's SSD scans, one a layer, each prompt alone from a zero
    state, in chunks of ``SSD_CHUNK``."""
    nq, _, hd = _heads(cfg)
    return cfg["num_layers"] * bound_s(ssd_scan_valid_work(
        lengths, nq, cfg["ssm_state"], hd, chunk=SSD_CHUNK,
        state_in=False))
