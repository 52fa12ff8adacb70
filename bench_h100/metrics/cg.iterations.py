"""Outer CG iterations per solve, the mean over the window."""


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
