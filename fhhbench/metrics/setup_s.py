"""setup_s: process start to the first timed collection: imports, CUDA
start-up, sampling, loading (or at the first run in a checkout, building)
the kernels, and the warm-up collection."""


def read(run):
    return run.setup_s
