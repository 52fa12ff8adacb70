"""Kernel launches per CG iteration of the profiler window inside the
Chebyshev smoother's spans: the phases pre and post at every level
(``mgtpu.smoother.pre@L<l>``, ``mgtpu.smoother.post@L<l>``)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import is_phase, launches_per_it  # noqa: E402

PHASES = ("pre", "post")


def read(run):
    return launches_per_it(run, lambda s: is_phase(s, *PHASES))
