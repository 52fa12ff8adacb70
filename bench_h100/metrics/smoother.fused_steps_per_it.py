"""Chebyshev smoother steps run as one kernel per CG iteration of the
profiler window: the device kernels whose names hold ``chebyshev_step``
(``dealii_multigrid_tpu_torch/csrc/chebyshev_step.cu``), so the steps of a
replayed CUDA graph count.  Each smoothed level takes five a V-cycle at
Chebyshev degree 3.  A program without the kernel reads nothing (None)."""

#: the kernel's name in the device trace
KERNELS = ("chebyshev_step",)


def read(run):
    t = run.trace
    if t is None or not t.iterations:
        return None
    n = sum(1 for name, _, _ in t.kernels() if any(k in name for k in KERNELS))
    return n / t.iterations if n else None
