"""Active slots per decode step inside the window: tokens the decode steps
produced over the engine's count of decode steps
(``LMServer.stats["decode_steps"]``)."""

from bench import layers

LAYER = "admission"
UNIT = "slots"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    n = run.stats1["decode_steps"] - run.stats0["decode_steps"]
    if n <= 0:
        return None
    return sum(len(d["positions"]) for d in layers.decodes(run)) / n
