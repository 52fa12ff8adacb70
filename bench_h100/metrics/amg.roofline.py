"""The AMG coarse solve's share of its roofline (%): the least time of the
window's coarse solves over the time its three phases took.

Least time per coarse solve: ``harness/amg_roofline.least_ms`` of the
hierarchy the port built (its published shape).  Coarse solves: one per
V-cycle, one V-cycle per CG iteration, so the window's CG iterations.
Time: the phases ``amg_smooth``, ``amg_transfer`` and ``amg_dense`` of the
port's PhaseRecorder (CUDA events around each phase, an upper bound of the
device time of its work).  None where the program publishes no shape or
records no AMG phase.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.amg_roofline import built_shape, least_ms  # noqa: E402

AMG = ("amg_smooth", "amg_transfer", "amg_dense")


def read(run):
    shape = built_shape()
    if shape is None or not run.phases or not run.iterations:
        return None
    if not all(k in run.phases for k in AMG):
        return None
    seconds = sum(run.phases[k] for k in AMG)
    if seconds <= 0:
        return None
    return 100.0 * 1e-3 * least_ms(shape) * sum(run.iterations) / seconds
