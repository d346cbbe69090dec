"""Milliseconds a decode step waits for the card after its launch: the
mean of the program's ``engine.decode.wait`` spans (the step's one host
copy of its packed tokens and done flags), capture steps left out; window
before the profiled span."""

from bench import steps

LAYER = "decode step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return steps.mean_ms(run, steps.decode_steps(run), "engine.decode.wait")
