"""Prefill attention's share of its bound in the profiled span: every
prefilled prompt alone at its own length, causal, windowed on the windowed
layers (``bench/calls.py``), over the device time of the kernel below
inside the admission calls."""

from bench import calls, layers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tokens_per_s"
KERNELS = ("flash_attention_kernel",)


def read(run):
    bound = sum(calls.flash_bound(run.family, run.cfg, a["lengths"])
                for a in layers.admits(run, traced=True))
    return layers.kernel_share(run, "admit", KERNELS, bound)
