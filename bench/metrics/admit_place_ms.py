"""Milliseconds a prefill dispatch spends placing its requests: the mean
of the program's ``engine.place`` spans (the first tokens' sample and
host copy, the scatter into the slots, the slot state's update); window
before the profiled span."""

from bench import steps

LAYER = "admission"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return steps.mean_ms(run, steps.steps(run, "engine.admit"),
                         "engine.place")
