"""Milliseconds a thousand dispatched tokens that the host spends issuing
the prefill: the program's ``engine.prefill.issue`` spans (the call to the
model's prefill, its host-to-device copies included, up to its return)
over each dispatch's prompts times its rung, the base of
``prefill_ms_per_ktok``; window before the profiled span."""

from bench import steps

LAYER = "prefill"
UNIT = "ms/ktok"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return steps.ms_per_ktok(run, "engine.prefill.issue")
