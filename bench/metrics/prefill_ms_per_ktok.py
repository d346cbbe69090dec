"""Milliseconds of prefill per thousand dispatched tokens: the program's
``lm.prefill`` spans (its tracer, through the engine's hook) summed over
the window before the profiled span, over each dispatch's admitted prompts times its padded length
(the span's ``batch`` and ``padded_len``)."""

from bench import layers

LAYER = "prefill"
UNIT = "ms/ktok"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    spans = layers.prefill_spans(run)
    tok = sum(a.get("batch", 0) * a.get("padded_len", 0) for _, _, a in spans)
    if not tok:
        return None
    return 1e3 * sum(b - a for a, b, _ in spans) / (tok / 1e3)
