"""RMSNorm's share of its bound in the decode steps of the profiled span:
the norms of every active slot's token (``bench/calls.py``) over the device
time of the kernel below inside the decode calls."""

from bench import calls, layers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tpot_p95_ms"
KERNELS = ("rmsnorm_kernel",)


def read(run):
    bound = sum(calls.rmsnorm_bound(run.family, run.cfg, len(d["positions"]))
                for d in layers.decodes(run, traced=True))
    return layers.kernel_share(run, "decode", KERNELS, bound)
