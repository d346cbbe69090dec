"""The SSD scan's share of its bound in the profiled span: every prefilled
prompt alone at its own length from a zero state (``bench/calls.py``), over
the device time of the kernels below inside the admission calls."""

from bench import calls, layers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tokens_per_s"
KERNELS = ("ssd_scan_kernel", "ssd_local_kernel", "ssd_carry_kernel",
           "ssd_y_kernel")


def read(run):
    if run.family != "hybrid":
        return None
    bound = sum(calls.ssd_bound(run.cfg, a["lengths"])
                for a in layers.admits(run, traced=True))
    return layers.kernel_share(run, "admit", KERNELS, bound)
