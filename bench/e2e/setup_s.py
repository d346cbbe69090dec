"""Process start to the start of the traffic schedule: imports, the
model's build, the weights, the kernels' load (and build in a fresh
checkout), and the warm-up of every prefill shape the mix can dispatch and
of the decode step's CUDA graph."""


def read(run):
    return run.setup_s
