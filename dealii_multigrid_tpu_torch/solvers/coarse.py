"""Coarse-grid solvers for the multigrid hierarchy.

Mirrors the reference's five coarse-solver variants
(multigrid_throughput.cc:909-1077):
  * "cg"                — CG with identity preconditioner
  * "cg_with_chebyshev" — CG preconditioned by Chebyshev-Jacobi
  * "cg_with_amg"       — CG preconditioned by the algebraic coarse solver
  * "amg"               — algebraic coarse solve, n_cycles applications
  * "amg_petsc"         — the second algebraic flavour (BoomerAMG analog)
and "direct".  The algebraic solver is an exact dense Cholesky, computed
once on the host and applied as two triangular solves on the device, while
the level has at most DIRECT_SOLVER_MAX_DOFS DoFs, and the
smoothed-aggregation AMG of solvers/amg.py above that.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..mesh.dof import Constraints, DoFHandler
from ..ops import element
from ..ops.operator import split_boundary_constraints
from .amg import AMGPreconditioner, build_amg, build_amg_boomer
from .cg import cg_solve
from .chebyshev import ChebyshevSmoother, estimate_eigenvalue_range

# problems up to this size use the exact dense Cholesky; larger ones get the
# smoothed-aggregation AMG (solvers/amg.py)
DIRECT_SOLVER_MAX_DOFS = 8000


def assemble_sparse_matrix(
    dofh: DoFHandler, hanging: Constraints, cell_weights: np.ndarray | None = None
) -> sp.csr_matrix:
    """Host-side assembly of the constrained system matrix C^T B C + I_c
    (reference: Operator::get_trilinos_system_matrix, operator.h:244-287).
    ``cell_weights`` scales each cell's stiffness (a cellwise constant
    coefficient, as make_operator(cell_weights=...))."""
    mesh, dim, p = dofh.mesh, dofh.dim, dofh.degree
    elem = element.laplace_element_matrix(dim, p)
    scale = mesh.h(mesh.level).astype(np.float64) ** (dim - 2)
    if cell_weights is not None:
        scale = scale * np.asarray(cell_weights, np.float64)
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


def _from_global(x: torch.Tensor, from_idx: torch.Tensor) -> torch.Tensor:
    """Global vector -> slots; the sentinel n_dofs (dummy slots) reads the
    zero appended here."""
    return torch.cat([x, x.new_zeros(1)])[from_idx]


@dataclass(frozen=True)
class DirectCoarseSolver:
    """Dense Cholesky coarse solve.

    With ``to_idx`` / ``from_idx`` it works on hybrid slot vectors:
    ``to_idx`` picks each DoF's representative slot, ``from_idx`` maps every
    slot to its DoF.  Without them the vectors are in the global layout.
    """

    L: torch.Tensor
    to_idx: torch.Tensor | None = None
    from_idx: torch.Tensor | None = None

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        bg = b[self.to_idx] if self.to_idx is not None else b
        y = torch.linalg.solve_triangular(
            self.L, bg.to(self.L.dtype).unsqueeze(1), upper=False
        )
        x = torch.linalg.solve_triangular(self.L.T, y, upper=True).squeeze(1)
        x = x.to(b.dtype)
        return x if self.from_idx is None else _from_global(x, self.from_idx)

    vmult = __call__


@dataclass(frozen=True)
class SlottedSolver:
    """Applies a global-layout solver to hybrid slot vectors."""

    inner: object
    to_idx: torch.Tensor
    from_idx: torch.Tensor

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        return _from_global(self.inner.vmult(b[self.to_idx]), self.from_idx)

    __call__ = vmult


@dataclass(frozen=True)
class CGCoarseSolver:
    """Inner-CG coarse solve with optional preconditioner.

    Mirrors MGCoarseGridIterativeSolver + ReductionControl (reference:
    multigrid_throughput.cc:909-960).  The inner CG stops on its own
    tolerance, so the V-cycle around it is a variable preconditioner, and it
    synchronises with the host once per inner iteration."""

    op: object
    preconditioner: object | None
    maxiter: int
    abstol: float
    reltol: float
    use_op_dot: bool

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        prec = self.preconditioner.vmult if self.preconditioner is not None else None
        dot = self.op.dot if self.use_op_dot else None
        return cg_solve(
            self.op.vmult, b, preconditioner=prec,
            maxiter=self.maxiter, abstol=self.abstol, reltol=self.reltol, dot=dot,
        ).x

    vmult = __call__


def find_amg(solver):
    """The AMGPreconditioner inside a coarse solver (itself, in a slot
    wrapper, or as the preconditioner of a coarse CG), else None."""
    inner = getattr(solver, "preconditioner", None) or solver
    inner = getattr(inner, "inner", inner)
    return inner if isinstance(inner, AMGPreconditioner) else None


def make_cg_coarse_solver(
    op, preconditioner=None, maxiter: int = 10000, abstol: float = 1e-20,
    reltol: float = 1e-4, use_op_dot: bool = False,
) -> CGCoarseSolver:
    return CGCoarseSolver(op, preconditioner, maxiter, abstol, reltol, use_op_dot)


def make_direct_coarse_solver(
    dofh: DoFHandler, hanging: Constraints, dtype: torch.dtype, device: torch.device,
    to_idx=None, from_idx=None,
) -> DirectCoarseSolver:
    """Dense Cholesky coarse solver (set-up on the host, apply on the device)."""
    A = assemble_sparse_matrix(dofh, hanging).toarray()
    L = torch.as_tensor(np.linalg.cholesky(A), dtype=dtype, device=device)
    return DirectCoarseSolver(L, to_idx, from_idx)


def make_algebraic_solver(
    dofh: DoFHandler,
    hanging: Constraints,
    dtype: torch.dtype,
    device: torch.device,
    mg_data=None,
    force_direct: bool = False,
    to_idx: torch.Tensor | None = None,
    from_idx: torch.Tensor | None = None,
    flavor: str = "sa",
):
    """The algebraic coarse solver: direct below the size limit (or when
    forced), else AMG in the ``flavor`` "sa" or "boomer" with
    ``mg_data.coarse_solver.n_cycles`` cycles.  ``to_idx`` / ``from_idx``
    wrap it for hybrid slot vectors."""
    if force_direct or dofh.n_dofs <= DIRECT_SOLVER_MAX_DOFS:
        return make_direct_coarse_solver(dofh, hanging, dtype, device, to_idx, from_idx)
    t0 = time.perf_counter()
    A = assemble_sparse_matrix(dofh, hanging)
    t_assemble = time.perf_counter() - t0
    n_cycles = mg_data.coarse_solver.n_cycles if mg_data else 1
    build = build_amg_boomer if flavor == "boomer" else build_amg
    amg = build(A, dtype=dtype, device=device, n_cycles=n_cycles)
    amg.setup_seconds["assemble"] = t_assemble
    if to_idx is None:
        return amg
    return SlottedSolver(amg, to_idx, from_idx)


def make_coarse_solver(
    kind: str,
    op,
    dofh: DoFHandler,
    hanging: Constraints,
    inv_diag: torch.Tensor | None = None,
    mg_data=None,
    dtype: torch.dtype = torch.float32,
):
    """Dispatch on CoarseGridSolverType for the gather engine (reference:
    multigrid_throughput.cc:909-1077); the hybrid engine's dispatch is
    api._hybrid_coarse_solver."""
    cs = mg_data.coarse_solver if mg_data else None
    maxiter = cs.maxiter if cs else 10000
    abstol = cs.abstol if cs else 1e-20
    reltol = cs.reltol if cs else 1e-4
    if kind == "cg":
        return make_cg_coarse_solver(op, None, maxiter, abstol, reltol)
    if kind == "cg_with_chebyshev":
        sm = mg_data.smoother if mg_data else None
        b0 = torch.as_tensor(
            np.random.default_rng(42).standard_normal(op.n_dofs),
            dtype=inv_diag.dtype, device=inv_diag.device,
        )
        lam_max, _ = estimate_eigenvalue_range(
            op, inv_diag, b0, sm.eig_cg_n_iterations if sm else 20
        )
        smoother = ChebyshevSmoother.create(
            op, inv_diag,
            max_eigenvalue=1.2 * lam_max,  # deal.II safety factor
            degree=sm.degree if sm else 5,
            smoothing_range=sm.smoothing_range if sm else 20.0,
        )
        return make_cg_coarse_solver(op, smoother, maxiter, abstol, reltol)
    if kind in ("amg", "amg_petsc", "direct"):
        return make_algebraic_solver(
            dofh, hanging, dtype, op.device, mg_data,
            force_direct=(kind == "direct"),
            flavor="boomer" if kind == "amg_petsc" else "sa",
        )
    if kind == "cg_with_amg":
        alg = make_algebraic_solver(dofh, hanging, dtype, op.device, mg_data)
        return make_cg_coarse_solver(op, alg, maxiter, abstol, reltol)
    raise ValueError(f"unknown coarse solver type {kind!r}")
