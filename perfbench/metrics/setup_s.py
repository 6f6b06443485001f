"""Process start to the first timed pass or iteration: imports, the CUDA
context, the scene tables, the kernels' loading (and building, in a
checkout's first run) and the warm-up."""


def read(run):
    return run.setup_s
