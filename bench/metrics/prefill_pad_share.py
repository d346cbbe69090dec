"""The share of the dispatched prefill tokens that are padding: the
program's ``engine.admit`` counters, Σ ``tokens_padded`` (rows × rung)
less Σ ``tokens_valid`` (the prompts' lengths), over Σ ``tokens_padded``,
in %; window before the profiled span."""

from bench import steps

LAYER = "prefill"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "tokens_per_s"


def read(run):
    admits = steps.admit_attrs(run)
    padded = sum(a["tokens_padded"] for a in admits)
    if not padded:
        return None
    return 100.0 * (padded - sum(a["tokens_valid"] for a in admits)) / padded
