"""Requests admitted per prefill dispatch inside the window: the prompts
the traced admission calls prefilled over the engine's count of prefill
dispatches (``LMServer.stats["prefill_dispatches"]``)."""

from bench import layers

LAYER = "admission"
UNIT = "req/dispatch"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    n = run.stats1["prefill_dispatches"] - run.stats0["prefill_dispatches"]
    if n <= 0:
        return None
    return sum(len(a["lengths"]) for a in layers.admits(run)) / n
