"""The yardstick's peaks and the patch stencil's least time.

A frozen copy of the arithmetic in ``chip_smoke.py`` (``bound``,
``HBM_BYTES_PER_S``, ``PEAK_FLOPS``): published peaks of one NVIDIA H100 SXM
(data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 and 34 TFLOP/s float64
outside the tensor cores, 989 TFLOP/s bfloat16 dense tensor cores).  The
least time of one stencil application is the larger of its bytes (read u,
the two assembled 1D matrices and the patch scales once, write the output
once) over the bandwidth and its operations inside the band over the peak;
the same work whatever implements it.  The 1D matrices are assembled here
from this module's own Gauss-Lobatto tables, not taken from the program.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from reference.poisson_q import gauss, gll_nodes, lagrange  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}


def assembled_nnz(p: int, S: int) -> tuple[int, int]:
    """Nonzeros of the 1D stiffness and mass matrices of K = (S - 1) / p
    elements of degree p assembled on S nodes."""
    K_el = (S - 1) // p
    nodes = gll_nodes(p)
    xq, wq = gauss(p + 2)
    v, d = lagrange(nodes, xq)
    out = []
    for loc in ((d * wq[:, None]).T @ d, (v * wq[:, None]).T @ v):
        A = np.zeros((S, S))
        for e in range(K_el):
            A[e * p:e * p + p + 1, e * p:e * p + p + 1] += loc
        out.append(int(np.count_nonzero(np.abs(A) > 1e-13 * np.abs(A).max())))
    return out[0], out[1]


def least_ms(NP: int, S: int, dtype: str, p: int = 4) -> tuple[float, str]:
    """Least time (ms) of one application on NP patches of S^3 slots, and
    which of bytes and operations bounds it."""
    size = BYTES[dtype]
    nbytes = (2 * NP * S**3 + 2 * S * S + NP) * size
    nnz_k, nnz_m = assembled_nnz(p, S)
    flops = NP * (2 * S * S * (3 * nnz_k + 4 * nnz_m) + S**3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")
