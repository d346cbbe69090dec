"""Model FLOPs of the prompts prefilled in the window before the profiled
span (``bench/model_count.py``, each prompt at its own length) over the
program's ``lm.prefill`` span time there, as a share of 989 TFLOP/s."""

from bench import layers
from bench.model_count import PEAK_BF16, prompt_flops

LAYER = "prefill"
UNIT = "%"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    spans = layers.prefill_spans(run)
    secs = sum(b - a for a, b, _ in spans)
    flops = sum(prompt_flops(run.family, run.cfg, L)
                for a in layers.admits(run) if not a["traced"]
                for L in a["lengths"])
    if not secs or not flops:
        return None
    return 100.0 * flops / secs / PEAK_BF16
