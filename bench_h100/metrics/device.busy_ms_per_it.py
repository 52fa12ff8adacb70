"""The device's busy time (the union of its activity intervals) per CG
iteration in the profiler window (ms): the device side of
`dof_solves_per_s`, steady where the host's speed is not."""


def read(run):
    t = run.trace
    if t is None or not t.iterations or not t.device:
        return None
    return 1e3 * t.busy_s() / t.iterations
