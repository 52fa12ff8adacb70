"""Seconds from the start of the process to the opening of the window: imports,
CUDA start, the kernel library, mesh, levels, eigenvalue estimates, loads and
the warm-up solve."""


def read(run):
    return run.setup_s
