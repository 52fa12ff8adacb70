"""Kernel launches per CG iteration of the profiler window inside the hybrid
operator's constraints: C, C^T on the structured faces and the per-node C^T
(``mgtpu.operator.apply_c``, ``mgtpu.operator.apply_ct_faces``,
``mgtpu.operator.apply_ct``), wherever the operator applies."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.spans import launches_per_it  # noqa: E402

SPANS = ("mgtpu.operator.apply_c", "mgtpu.operator.apply_ct_faces", "mgtpu.operator.apply_ct")


def read(run):
    return launches_per_it(run, lambda s: s.name in SPANS)
