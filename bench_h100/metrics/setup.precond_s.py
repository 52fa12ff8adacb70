"""The harness's fenced span around the preconditioner build, eigenvalue
estimates included (s)."""


def read(run):
    return run.spans.get("precond_s")
