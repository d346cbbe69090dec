"""Host milliseconds per decode step: the harness's intervals around the
engine's decode calls inside the window and before the profiled span
(each ends with the step's one host copy), over those steps."""

from bench import layers

LAYER = "decode step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "tpot_p95_ms"


def read(run):
    ds = layers.untraced_decodes(run)
    return 1e3 * layers.decode_seconds(run) / len(ds) if ds else None
