"""The coarse solve per CG iteration (ms)."""


def read(run):
    return run.phase_ms_per_it(("cs",))
