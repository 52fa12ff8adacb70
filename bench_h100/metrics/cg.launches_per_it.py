"""Kernel launches per CG iteration of the profiler window inside the outer
CG's iteration spans (``mgtpu.cg.iteration``) and outside the
preconditioner's (``mgtpu.vcycle.precondition``): the outer operator, the
dots, the vector updates and the convergence test."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import CG_ITERATION, PRECONDITION, launches_per_it  # noqa: E402


def read(run):
    return launches_per_it(
        run, lambda s: s.name == CG_ITERATION, minus=lambda s: s.name == PRECONDITION
    )
