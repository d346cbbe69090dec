"""Decode attention's share of its bound in the profiled span: the bound of
every decode step's attention at its active slots' valid positions
(``bench/calls.py``) over the device time of the kernels below inside the
decode calls."""

from bench import calls, layers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tpot_p95_ms"
KERNELS = ("decode_attention_kernel", "decode_merge_kernel")


def read(run):
    ml = int(run.mix["server"]["max_len"])
    bound = sum(calls.decode_attention_bound(run.family, run.cfg, ml,
                                             d["positions"])
                for d in layers.decodes(run, traced=True))
    return layers.kernel_share(run, "decode", KERNELS, bound)
