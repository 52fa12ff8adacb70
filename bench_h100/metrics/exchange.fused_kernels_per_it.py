"""Assembly exchange kernels per CG iteration of the profiler window: the
device kernels whose names hold ``assembly_exchange``
(``dealii_multigrid_tpu_torch/csrc/assembly_exchange.cu``), so the launches
of a replayed CUDA graph count.  Each exchange on a float32 or float64
level takes one launch per sweep axis with a group, three on every level
above the coarsest.  A program without the kernel reads nothing (None)."""

#: the kernel's name in the device trace
KERNELS = ("assembly_exchange",)


def read(run):
    t = run.trace
    if t is None or not t.iterations:
        return None
    n = sum(1 for name, _, _ in t.kernels() if any(k in name for k in KERNELS))
    return n / t.iterations if n else None
