"""Bytes the decode steps of the window had to read (every weight once, all
of dbrx's experts; each active slot's K and V of the positions it sees;
hymba's SSD and conv states read and written; ``bench/model_count.py``)
over the decode calls' host time, both before the profiled span, as a
share of 3.35 TB/s."""

from bench import layers
from bench.model_count import PEAK_BYTES, decode_step_bytes

LAYER = "decode step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "tpot_p95_ms"


def read(run):
    secs = layers.decode_seconds(run)
    nbytes = sum(decode_step_bytes(run.family, run.cfg, d["positions"])
                 for d in layers.untraced_decodes(run))
    if not secs or not nbytes:
        return None
    return 100.0 * nbytes / secs / PEAK_BYTES
