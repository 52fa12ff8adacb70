"""90th percentile of the solve times of the window, each from its start to the
synchronize after its last iteration (host clock), in ms."""


def read(run):
    import statistics

    if len(run.solve_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.solve_s, n=10, method="inclusive")[-1]
