"""Model FLOPs of the tokens the decode steps produced in the window
(each active slot's token at its position, ``bench/model_count.py``) over
the decode calls' host time, both before the profiled span, as a share
of 989 TFLOP/s."""

from bench import layers
from bench.model_count import PEAK_BF16, token_flops

LAYER = "decode step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "tpot_p95_ms"


def read(run):
    secs = layers.decode_seconds(run)
    flops = sum(token_flops(run.family, run.cfg, p)
                for d in layers.untraced_decodes(run) for p in d["positions"])
    if not secs or not flops:
        return None
    return 100.0 * flops / secs / PEAK_BF16
