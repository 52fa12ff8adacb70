"""One step of the Chebyshev-Jacobi smoother in one pass over the level vector.

``recurrence_step`` and ``first_step`` are the entry points.  Each takes the
operator's result before its identity blend on constrained slots
(``HybridOperator.vmult_split``: ``ar`` and the blend's ``keep``) and
returns the step's new iterate and update ``(x', d')``:

  ax = ar keep + x (1 - keep),  r = b - ax,
  d' = c_d d + c_r (inv_diag r)   (recurrence_step), or
  d' = (inv_diag r) / theta       (first_step, ``ChebyshevSmoother.step``),
  x' = x + d'.

Each launches the hand-written kernel in ``csrc/chebyshev_step.cu`` (built
and counted as ops/kernels.py sets out) on CUDA tensors, or raises.  Its
plain version is the smoother's eager chain (``recurrence_reference``,
``first_reference``) after ``blend``, which every other case runs
(solvers/chebyshev.py, ``takes_kernel``).  The kernel gives the eager
chain's result on the card bit for bit: the same operations in the same
order, each rounded on its own, and ``theta``'s reciprocal computed here as
PyTorch's CUDA division by a CPU scalar computes it.  It allocates only x'
and d'.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

#: the kernel's entry point per dtype
_ENTRY = {torch.float32: "chebyshev_step_f32", torch.float64: "chebyshev_step_f64"}
#: the dtypes the kernel takes
DTYPES = tuple(_ENTRY)

#: launches of the CUDA kernel that reached the card (ops/kernels.py)
launches = kernels.counter("chebyshev_step")


def bind(lib: ctypes.CDLL, path: str) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_void_p]
        )


library = kernels.Library("chebyshev_step", bind)


# ------------------------------------------------------------- plain versions
def blend(ar: torch.Tensor, keep: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x from the operator's result before its blend: the identity on
    constrained slots, as ``HybridOperator.vmult`` ends."""
    return ar * keep + x * (1.0 - keep)


def recurrence_reference(ax, x, d, b, inv_diag, c_d, c_r):
    """(x', d') of a recurrence step from A x: the smoother's eager chain."""
    r = b - ax
    d = c_d * d + c_r * (inv_diag * r)
    return x + d, d


def first_reference(ax, x, b, inv_diag, theta: float):
    """(x', d') of the first step of a smoothing from ``x``, from A x: the
    smoother's eager chain."""
    r = b - ax
    d = (inv_diag * r) / theta
    return x + d, d


# --------------------------------------------------------------- the kernel
def reciprocal(theta: float, dtype: torch.dtype) -> float:
    """1 / theta in ``dtype``, as PyTorch's CUDA kernel for a tensor divided
    by a CPU scalar computes it (``opmath(1) / b``, then a multiply)."""
    if dtype == torch.float32:
        return float(np.float32(1.0) / np.float32(theta))
    return 1.0 / float(theta)


def _launch(first: bool, ar, keep, x, d, b, inv_diag, c_d: float, c_r: float,
            inv_theta: float):
    if x.device.type != "cuda":
        raise ValueError(f"the Chebyshev step kernel runs on CUDA tensors, not {x.device}")
    vecs = {"ar": ar, "keep": keep, "x": x, "d": d, "b": b, "inv_diag": inv_diag}
    for name, t in vecs.items():
        if t.dim() != 1 or t.shape != x.shape:
            raise ValueError(f"{name} must be a vector of {x.shape[0]} slots, got {tuple(t.shape)}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _ENTRY:
        raise ValueError(f"the Chebyshev step kernel takes float32 or float64, got {x.dtype}")
    device = x.device.index or 0
    lib = library.for_device(device)
    d_out, x_out = torch.empty_like(x), torch.empty_like(x)
    err = getattr(lib, _ENTRY[x.dtype])(
        ar.data_ptr(), keep.data_ptr(), x.data_ptr(), b.data_ptr(), d.data_ptr(),
        inv_diag.data_ptr(), d_out.data_ptr(), x_out.data_ptr(), x.shape[0], int(first),
        c_d, c_r, inv_theta, device, torch.cuda.current_stream(x.device).cuda_stream,
    )
    library.check(err, "launch")
    launches.add(x.dtype)
    return x_out, d_out


def recurrence_step(ar, keep, x, d, b, inv_diag, c_d, c_r):
    """(x', d') of one step of the three-term recurrence, from the operator's
    result before its blend ``ar`` and the blend's ``keep``; ``c_d`` and
    ``c_r`` are scalars in the vector's dtype (0-d CPU tensors or floats).
    ``x`` and ``d`` may be one tensor.  Launches the kernel or raises."""
    return _launch(False, ar, keep, x, d, b, inv_diag, float(c_d), float(c_r), 0.0)


def first_step(ar, keep, x, b, inv_diag, theta: float):
    """(x', d') of the first step of a smoothing from ``x``, with
    d' = (inv_diag r) / theta; otherwise as ``recurrence_step``."""
    return _launch(True, ar, keep, x, x, b, inv_diag, 0.0, 0.0, reciprocal(theta, x.dtype))
