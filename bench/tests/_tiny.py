"""Tiny configurations and mixes the CPU tests run the harness with."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

HYMBA = {"name": "hymba-tiny", "family": "hybrid", "num_layers": 4,
         "global_layers": [0, 3], "d_model": 64, "num_heads": 4,
         "num_kv_heads": 2, "d_ff": 128, "vocab_size": 300, "ssm_state": 4,
         "conv_width": 4, "window": 32, "rope_theta": 10000.0,
         "norm_eps": 1e-5}
MOE = {"name": "moe-tiny", "family": "moe", "num_layers": 3, "d_model": 64,
       "num_heads": 4, "num_kv_heads": 2, "d_ff": 96, "vocab_size": 300,
       "num_experts": 4, "num_experts_per_tok": 2,
       "moe_capacity_factor": 2.0, "rope_theta": 500000.0, "norm_eps": 1e-5}
CHECK = {"min_tokens": 120, "max_requests": 16, "min_compared": 10,
         "gap_limit": 0.1}
# the tiny models' limits by statistic: sound runs on the CPU read about
# 0.007 (widest gap) and 0.001 (mean gap) here
TINY_LIMIT = {"max": 0.1, "mean": 0.02}
OPEN = {"mode": "open", "rate": 20.0, "lead_s": 0.3,
        "server": {"slots": 4, "max_len": 96, "slo_s": 0.5},
        "prompt": [{"share": 0.7, "dist": "uniform", "lo": 8, "hi": 32},
                   {"share": 0.3, "dist": "uniform", "lo": 33, "hi": 60}],
        "output": [{"share": 1.0, "dist": "uniform", "lo": 4, "hi": 12}],
        "check": CHECK}
CLOSED = {"mode": "closed", "backlog": 8, "lead_s": 0.3,
          "server": {"slots": 4, "max_len": 96, "slo_s": 0.5},
          "prompt": [{"share": 1.0, "dist": "loguniform", "lo": 8,
                      "hi": 40}],
          "output": [{"share": 1.0, "dist": "loguniform", "lo": 8,
                      "hi": 24}],
          "check": CHECK}


def overrides(cell: str):
    """The tiny stand-ins for ``cell``'s configuration and mix; the check
    compares the statistic the cell's own mix names."""
    import json
    mix = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json")
                     .read_text())
    stat = mix["check"].get("statistic", "max")
    small = CLOSED if cell.startswith("dbrx") else OPEN
    small = dict(small, check=dict(CHECK, statistic=stat,
                                   gap_limit=TINY_LIMIT[stat]))
    return {"config": MOE if cell.startswith("dbrx") else HYMBA,
            "mix": small}
