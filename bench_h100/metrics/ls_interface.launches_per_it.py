"""Kernel launches per CG iteration of the profiler window inside local
smoothing's refinement-edge operators and its copies to and from the level
vectors (``mgtpu.ls_interface.edge_pro@L<l>``, ``mgtpu.vcycle.to_mg@L<l>``,
``mgtpu.vcycle.to_global@L<l>``); HMG-local cells only."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import is_phase, launches_per_it  # noqa: E402

PHASES = ("edge_pro", "to_mg", "to_global")


def read(run):
    if not run.local_smoothing:
        return None
    return launches_per_it(run, lambda s: is_phase(s, *PHASES))
