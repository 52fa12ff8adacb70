"""The least bytes and least time of one AMG coarse solve.

The port publishes the shape of the latest AMG hierarchy it built
(``dealii_multigrid_tpu_torch/utils/phases.py``, ``AMG_SHAPE``): per
level, finest first, its rows, the stored entries of A and of the
prolongator P from the next coarser level, the values' dtype, and the dense
coarsest level's rows, the nonzeros of its matrix's lower triangle
(diagonal included), its factor's dtype, ``n_cycles`` and ``n_smooth``.
From that shape alone this module counts what one coarse solve must move,
whatever computes it:

* each sparse product the V-cycle states reads its stored entries once,
  value and 4-byte column index, and its input vector once, and writes its
  output once: nnz x (value + 4) + (rows + cols) x value bytes.  Entries,
  not the ELL padding;
* on each level above the coarsest, a V-cycle states ``n_smooth``
  pre-smoothing sweeps from zero, the first of which needs no product
  with A, ``n_smooth`` post-smoothing sweeps, and one residual: 2 x
  ``n_smooth`` products with A; and one product with P^T (restriction)
  and one with P (prolongation);
* the coarsest level's two triangular solves each read the nonzeros of
  the factor, at least those of the matrix's lower triangle, as a sparse
  product: ``dense_nnz`` x (factor bytes + 4) + 2 n x factor bytes.  A
  dense factor's zeros are not counted (at quadrant r=7 p=1 that level is
  diagonal);
* a coarse solve is ``n_cycles`` V-cycles and ``n_cycles - 1`` residuals
  on the finest level.

The vector updates (the Jacobi step, the corrections) are left out, so the
count is a lower bound of any implementation's traffic, and the time at
``HBM_BYTES_PER_S`` (``harness/roofline.py``) a lower bound of its time.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from harness.roofline import BYTES, HBM_BYTES_PER_S  # noqa: E402

INDEX_BYTES = 4
#: where the port publishes its AMG shapes
PORT_PHASES = "dealii_multigrid_tpu_torch.utils.phases"


def product_bytes(nnz: int, rows: int, cols: int, value_bytes: int) -> int:
    """Least bytes of one sparse matrix-vector product."""
    return nnz * (value_bytes + INDEX_BYTES) + (rows + cols) * value_bytes


def least_bytes(shape: dict) -> int:
    """Least bytes of one coarse solve of the hierarchy ``shape`` (one
    record of the port's ``AMG_SHAPE``)."""
    vb = BYTES[shape["value_dtype"]]
    levels = shape["levels"]
    n = shape["dense_rows"]
    vcycle = 2 * product_bytes(shape["dense_nnz"], n, n, BYTES[shape["factor_dtype"]])
    for fine, coarse in zip(levels, levels[1:]):
        rows, rows_c = fine["rows"], coarse["rows"]
        a = product_bytes(fine["nnz_A"], rows, rows, vb)
        p = product_bytes(coarse["nnz_P"], rows, rows_c, vb)
        vcycle += 2 * shape["n_smooth"] * a + 2 * p
    finest = levels[0]
    residual = product_bytes(finest["nnz_A"], finest["rows"], finest["rows"], vb)
    return shape["n_cycles"] * vcycle + (shape["n_cycles"] - 1) * residual


def least_ms(shape: dict) -> float:
    """Least time (ms) of one coarse solve at the card's HBM bandwidth."""
    return 1e3 * least_bytes(shape) / HBM_BYTES_PER_S


def built_shape() -> dict | None:
    """The shape of the latest AMG hierarchy the port built in this process,
    or None (no AMG built, or a program that publishes none)."""
    shape = getattr(sys.modules.get(PORT_PHASES), "AMG_SHAPE", None)
    return dict(shape) if shape else None
