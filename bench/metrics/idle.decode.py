"""The device's idle share inside the decode calls of the profiled span:
1 - the union of device-operation intervals inside them over their host
time."""

from bench import layers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tpot_p95_ms"


def read(run):
    return layers.idle_share(run, "decode")
