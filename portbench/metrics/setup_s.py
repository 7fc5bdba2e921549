"""setup_s: process start to the window's start (host clock): imports, CUDA
initialisation, loading the built kernels, the solver, the amplitude sets and
the warm-up calls."""


def read(run):
    return run.setup_s
