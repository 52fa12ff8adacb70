"""The patch-stencil kernel's share of its roofline (%) in the profiler
window: the sum of its least times over the sum of its device times.

Least time per application: ``harness/roofline.least_ms`` at each level's
(NP, S, dtype, degree).  Applications: the hierarchy's per-iteration
entries (``harness/system.System.entries``) times the CG iterations of the
profiler window, not the program's launch counter.  Kernels: the device
kernels whose names hold one of ``KERNELS``; a program that renames or
fuses the kernel leaves this list to a benchmark change.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.roofline import dtype_name, least_ms  # noqa: E402

#: the stencil's kernel names in the device trace (csrc/patch_stencil.cu)
KERNELS = ("fused_stencil",)


def read(run):
    t = run.trace
    if t is None or not t.iterations or not run.entries:
        return None
    device_s = sum(b - a for name, a, b in t.kernels() if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    least_s = 1e-3 * t.iterations * sum(
        e.per_iteration * least_ms(e.op.NP, e.op.S, dtype_name(e.dtype), e.degree)[0]
        for e in run.entries
    )
    return 100.0 * least_s / device_s
