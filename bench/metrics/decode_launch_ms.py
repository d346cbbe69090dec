"""Milliseconds the host spends launching a decode step: the mean of the
program's ``engine.decode.launch`` spans (the CUDA graph's replay and its
launches' crediting, or an eager step's issue), capture steps left out;
window before the profiled span."""

from bench import steps

LAYER = "decode step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return steps.mean_ms(run, steps.decode_steps(run), "engine.decode.launch")
