"""setup_s: process start to the start of the measured window (host
clock): imports, the kernel build or its cache, the solver, the warm-up."""


def read(run):
    return run.setup_s
