"""1 - the device's busy time over the host time the same work takes
without the profiler.

The busy time is the union of the device's activity intervals in the
profiler window; the denominator is the run's window (solves without the
profiler) in seconds per CG iteration, times the profiler window's
iterations, since recording the host's operators stretches the host side
of the profiled solves (the profiler window's own idle share is
``1 - busy_s / window_s`` in the result's ``device``)."""


def read(run):
    t = run.trace
    if t is None or not t.iterations or not t.device or not run.iterations or run.window_s <= 0:
        return None
    host_s = run.window_s / sum(run.iterations) * t.iterations
    return 1.0 - t.busy_s() / host_s
