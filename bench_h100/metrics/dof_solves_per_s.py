"""DoFs times solves completed in the window, over the window's seconds (host clock)."""


def read(run):
    done = sum(run.converged)
    return run.n_dofs * done / run.window_s if run.window_s > 0 else None
