"""Kernel launches per CG iteration of the profiler window inside the V-cycle
phase spans of every level below the finest (``mgtpu.<layer>.<phase>@L<l>``
with l under the largest level in the window), the coarse solve's
(``mgtpu.coarse.cs@L0``) included."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import launches_per_it, spans  # noqa: E402


def read(run):
    if run.trace is None:
        return None
    levels = [s.level for s in spans(run.trace) if s.level is not None]
    if not levels:
        return None
    top = max(levels)
    return launches_per_it(run, lambda s: s.level is not None and s.level < top)
