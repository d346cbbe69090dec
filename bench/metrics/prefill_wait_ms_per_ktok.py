"""Milliseconds a thousand dispatched tokens that the host waits for the
card to finish the prefill it issued: the program's
``engine.prefill.wait`` spans (the synchronize after the issue) over the
base of ``prefill_issue_ms_per_ktok``; window before the profiled span.
With it, issue re-reads ``prefill_ms_per_ktok``."""

from bench import steps

LAYER = "prefill"
UNIT = "ms/ktok"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return steps.ms_per_ktok(run, "engine.prefill.wait")
