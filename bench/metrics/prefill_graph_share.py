"""The share of prefill dispatches replayed from a CUDA graph: the
program's ``engine.admit`` spans whose ``mode`` is "replay" (not "eager",
nor "capture", which captures the shape's graph), over all, in %; window
before the profiled span. A program whose admission spans carry no
``mode`` gives no reading."""

from bench import steps

LAYER = "prefill"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    modes = [a["mode"] for a in steps.admit_attrs(run) if "mode" in a]
    if not modes:
        return None
    return 100.0 * modes.count("replay") / len(modes)
