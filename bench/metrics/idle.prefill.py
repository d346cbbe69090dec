"""The device's idle share inside the admission calls that prefilled, in
the profiled span: 1 - the union of device-operation intervals inside them
over their host time."""

from bench import layers

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return layers.idle_share(run, "admit")
