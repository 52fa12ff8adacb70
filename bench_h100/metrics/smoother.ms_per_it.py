"""Chebyshev pre- and post-smoothing per CG iteration (ms)."""


def read(run):
    return run.phase_ms_per_it(("pre", "post"))
