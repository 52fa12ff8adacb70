"""Coarse-grid solver: a dense Cholesky factorisation of the coarsest level.

The reference's "amg" coarse type resolves to the exact dense Cholesky
when the coarsest level has at most DIRECT_SOLVER_MAX_DOFS DoFs
(dealii_multigrid_tpu/solvers/coarse.py:204-218); the factor is computed
once on the host and applied as two triangular solves on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..mesh.dof import Constraints, DoFHandler
from ..ops import element
from ..ops.operator import split_boundary_constraints

# problems up to this size use the exact dense Cholesky
DIRECT_SOLVER_MAX_DOFS = 8000


def assemble_sparse_matrix(dofh: DoFHandler, hanging: Constraints) -> sp.csr_matrix:
    """Host-side assembly of the constrained system matrix C^T B C + I_c
    (reference: Operator::get_trilinos_system_matrix, operator.h:244-287)."""
    mesh, dim, p = dofh.mesh, dofh.dim, dofh.degree
    elem = element.laplace_element_matrix(dim, p)
    scale = mesh.h(mesh.level).astype(np.float64) ** (dim - 2)
    nloc = dofh.n_loc
    n = dofh.n_dofs
    rows = np.repeat(dofh.cell_dofs.astype(np.int64), nloc, axis=1).reshape(-1)
    cols = np.tile(dofh.cell_dofs.astype(np.int64), (1, nloc)).reshape(-1)
    vals = (scale[:, None, None] * elem[None]).reshape(-1)
    B = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))

    hang, dirichlet = split_boundary_constraints(dofh, hanging)
    constrained = np.zeros(n, dtype=bool)
    constrained[dirichlet] = True
    constrained[hang.slave] = True
    C = sp.diags((~constrained).astype(np.float64)).tocsr()
    if len(hang.slave):
        m = hang.masters.reshape(-1)
        w = hang.weights.reshape(-1)
        r = np.repeat(hang.slave, hang.masters.shape[1])
        nz = (w != 0) & ~constrained[m]
        C = C + sp.csr_matrix((w[nz], (r[nz], m[nz])), shape=(n, n))
    A = (C.T @ B @ C).tocsr()
    Ic = sp.diags(constrained.astype(np.float64))
    return (A + Ic).tocsr()


@dataclass(frozen=True)
class DirectCoarseSolver:
    """Dense Cholesky coarse solve on hybrid slot vectors.

    ``to_idx`` picks each DoF's representative slot; ``from_idx`` maps every
    slot to its DoF, with the sentinel n_dofs (dummy slots) reading the zero
    that the apply appends.
    """

    L: torch.Tensor
    to_idx: torch.Tensor
    from_idx: torch.Tensor

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        bg = b[self.to_idx].to(self.L.dtype).unsqueeze(1)
        y = torch.linalg.solve_triangular(self.L, bg, upper=False)
        x = torch.linalg.solve_triangular(self.L.T, y, upper=True).squeeze(1)
        x = x.to(b.dtype)
        return torch.cat([x, x.new_zeros(1)])[self.from_idx]


def make_algebraic_solver(
    dofh: DoFHandler, hanging: Constraints, to_idx: torch.Tensor,
    from_idx: torch.Tensor, dtype: torch.dtype,
) -> DirectCoarseSolver:
    """The "amg" coarse type on the port: direct below the size limit."""
    if dofh.n_dofs > DIRECT_SOLVER_MAX_DOFS:
        raise NotImplementedError(
            f"coarse level has {dofh.n_dofs} DoFs > {DIRECT_SOLVER_MAX_DOFS}: "
            "the algebraic multigrid coarse solver is not ported yet "
            "(ROADMAP item 10, AMG)"
        )
    A = assemble_sparse_matrix(dofh, hanging).toarray()
    L = torch.as_tensor(np.linalg.cholesky(A), dtype=dtype, device=to_idx.device)
    return DirectCoarseSolver(L, to_idx, from_idx)
