"""Kernel launches per CG iteration of the profiler window inside the hybrid
operator's assembly exchange (``mgtpu.operator.exchange``), wherever the
operator applies: the V-cycle's phases, local smoothing's interface
operators and the outer CG's vmult."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import launches_per_it  # noqa: E402

SPANS = ("mgtpu.operator.exchange",)


def read(run):
    return launches_per_it(run, lambda s: s.name in SPANS)
