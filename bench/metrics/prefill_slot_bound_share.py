"""The share of prefill dispatches whose size the free slots alone capped:
the program's ``engine.admit`` counters, dispatches with ``limit`` "slots"
(not tied with AIMD's budget or the queue, "slots+budget" and the like)
over all, in %; window before the profiled span."""

from bench import steps

LAYER = "admission"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    admits = steps.admit_attrs(run)
    if not admits:
        return None
    return 100.0 * sum(a["limit"] == "slots" for a in admits) / len(admits)
