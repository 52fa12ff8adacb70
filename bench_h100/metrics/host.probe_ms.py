"""The host CPU's speed over the traced window: the median time (ms) of a
fixed pure-Python loop (``harness/bench.host_probe``) run after each solve.
The solves are host-dispatched, so their times follow it; a change of the
rate that this reading moves with is the host's, not the program's."""


def read(run):
    import statistics

    if not run.probe_s:
        return None
    return 1e3 * statistics.median(run.probe_s)
