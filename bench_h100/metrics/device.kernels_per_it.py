"""Device kernels in the profiler window per CG iteration there."""


def read(run):
    t = run.trace
    if t is None or not t.iterations or not t.kernels():
        return None
    return len(t.kernels()) / t.iterations
