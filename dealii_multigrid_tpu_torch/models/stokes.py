"""Stokes flow with constant viscosity: Q2-Q1 (Taylor-Hood) block operator
and block preconditioners, on torch.

Mirror of the JAX package's models/stokes.py (the first slice of the
mantle-convection workload, which the reference only points at,
mantle-convection/README.md:1-25):

  * viscous block A: the vector Laplacian (ops/vector.py::VectorOperator
    over the gather-engine scalar operator, component-major ``[3, n_v]``)
    with homogeneous Dirichlet velocity;
  * coupling B (pressure test x velocity divergence): assembled exactly on
    the host per cell from 1D mixed-degree integrals, applied as padded-ELL
    products (solvers/amg.py::ELLMatrix) on the caller's device;
  * preconditioners: block-diagonal [GMG V-cycle per velocity component,
    S_hat^{-1}] around MINRES, and block upper-triangular around FGMRES
    (solvers/gmres.py), with S_hat the pressure mass.

The saddle operator keeps Dirichlet velocity rows as identity (B's
constrained columns are masked); the hydrostatic pressure mode is removed
by projecting the right-hand side mean-free.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .. import api
from ..mesh.coarsening import geometric_coarsening_sequence
from ..mesh.dof import DoFHandler, distribute_dofs, make_hanging_node_constraints
from ..mesh.octree import AdaptiveMesh
from ..ops import tensor
from ..ops.vector import VectorOperator
from ..solvers.amg import ELLMatrix, _to_ell
from ..solvers.chebyshev import ChebyshevSmoother
from ..solvers.multigrid import PreconditionMG
from ..utils.device import resolve_device


def _mixed_1d_tables(p_v: int, p_p: int):
    """(G, M): G[a, b] = int m_a l'_b, M[a, b] = int m_a l_b on [0, 1] for
    pressure basis m (degree p_p) and velocity basis l (degree p_v)."""
    q, w = tensor.gauss_points(p_v + p_p + 1)
    mp = tensor.lagrange_values(tensor.gauss_lobatto_points(p_p + 1), q)
    lv = tensor.lagrange_values(tensor.gauss_lobatto_points(p_v + 1), q)
    dv = tensor.lagrange_derivatives(tensor.gauss_lobatto_points(p_v + 1), q)
    G = np.einsum("q,qa,qb->ab", w, mp, dv)
    M = np.einsum("q,qa,qb->ab", w, mp, lv)
    return G, M


def assemble_divergence(dofh_v: DoFHandler, dofh_p: DoFHandler) -> sp.csr_matrix:
    """B [n_p, 3 * n_v] with component-major velocity columns:
    B[q, c * n_v + i] = int_Omega m_q d_c(l_i).  Exact on the uniform
    hexahedral mesh (per-cell tensor products of 1D integrals, physical
    scaling h^2 per cell)."""
    mesh = dofh_v.mesh
    G, M = _mixed_1d_tables(dofh_v.degree, dofh_p.degree)
    n1v, n1p = dofh_v.degree + 1, dofh_p.degree + 1

    # local tensor blocks per component: Bc[(qz,qy,qx),(iz,iy,ix)]
    def kron3(Az, Ay, Ax):
        return np.einsum("ad,be,cf->abcdef", Az, Ay, Ax).reshape(n1p**3, n1v**3)

    Bloc = [kron3(M, M, G), kron3(M, G, M), kron3(G, M, M)]  # d_x, d_y, d_z
    n_v, n_p = dofh_v.n_dofs, dofh_p.n_dofs
    scale = mesh.h(mesh.level) ** 2  # h^3 volume x h^-1 derivative
    rows = np.repeat(dofh_p.cell_dofs, n1v**3, axis=1).reshape(-1)
    cols = np.tile(dofh_v.cell_dofs, (1, n1p**3)).reshape(-1)
    B = sp.csr_matrix(
        (
            np.concatenate([(scale[:, None, None] * Bc[None]).reshape(-1) for Bc in Bloc]),
            (np.tile(rows, 3), np.concatenate([cols + c * n_v for c in range(3)])),
        ),
        shape=(n_p, 3 * n_v),
    )
    B.sum_duplicates()
    return B


@dataclass(frozen=True)
class StokesOperator:
    """Symmetric saddle operator on flat vectors [3 * n_v + n_p]:
    [[A, keep .* B^T], [B .* keep, 0]] with identity on Dirichlet velocity
    rows (the constrained-row convention of the scalar operators)."""

    a_op: VectorOperator     # vmult on [3, n_v]
    B: ELLMatrix             # [n_p, 3 n_v]
    Bt: ELLMatrix            # [3 n_v, n_p]
    keep_v: torch.Tensor     # [3 * n_v]: 0 on Dirichlet velocity DoFs
    n_v: int
    n_p: int

    @property
    def dtype(self) -> torch.dtype:
        return self.a_op.dtype

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        u, p = x[: 3 * self.n_v], x[3 * self.n_v :]
        au = self.a_op.vmult(u.view(3, self.n_v)).reshape(-1)
        btp = self.Bt.matvec(p) * self.keep_v
        return torch.cat([au + btp, self.B.matvec(u * self.keep_v)])

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sum(x * y)


@dataclass(frozen=True)
class LumpedMassSolve:
    """S_hat^{-1} as the inverse lumped (row-sum) pressure mass."""

    inv_lump: torch.Tensor

    def vmult(self, r: torch.Tensor) -> torch.Tensor:
        return self.inv_lump * r


@dataclass(frozen=True)
class MassOperator:
    """The consistent pressure mass as an ELL operator."""

    M: ELLMatrix

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        return self.M.matvec(x)

    @property
    def dtype(self) -> torch.dtype:
        return self.M.vals.dtype


@dataclass(frozen=True)
class StokesBlockPreconditioner:
    """diag(GMG(A) per component, S_hat^-1): SPD, spectrally equivalent to
    diag(A, S)^-1 for Taylor-Hood (the pressure mass is spectrally
    equivalent to the Schur complement).  ``p_solve`` applies S_hat^{-1};
    the production choice is Chebyshev on the consistent mass (lumping
    alone widens the preconditioned Schur interval, see build_stokes)."""

    v_precond: object        # scalar preconditioner with vmult (PreconditionMG)
    p_solve: object          # S_hat^{-1} with vmult
    n_v: int
    n_p: int

    def vmult(self, r: torch.Tensor) -> torch.Tensor:
        ru = r[: 3 * self.n_v].view(3, self.n_v)
        zu = torch.cat([self.v_precond.vmult(c) for c in ru])
        return torch.cat([zu, self.p_solve.vmult(r[3 * self.n_v :])])

    __call__ = vmult


@dataclass(frozen=True)
class StokesTriangularPreconditioner:
    """Block upper-triangular P = [[A_hat, B^T], [0, -S_hat]], the
    nonsymmetric upgrade of the block-diagonal preconditioner
    (Elman/Silvester/Wathen ch. 9): with the same blocks the preconditioned
    spectrum clusters near 1, cutting the outer count ~3x against
    block-diagonal MINRES at the cost of symmetry; pair it with FGMRES."""

    v_precond: object
    p_solve: object
    Bt: ELLMatrix            # [3 n_v, n_p]
    keep_v: torch.Tensor     # [3 * n_v]
    n_v: int
    n_p: int

    def vmult(self, r: torch.Tensor) -> torch.Tensor:
        zp = -self.p_solve.vmult(r[3 * self.n_v :])
        w = (r[: 3 * self.n_v] - self.Bt.matvec(zp) * self.keep_v).view(3, self.n_v)
        zu = torch.cat([self.v_precond.vmult(c) for c in w])
        return torch.cat([zu, zp])

    __call__ = vmult


def minres_solve(
    a_vmult,
    b: torch.Tensor,
    preconditioner=None,
    maxiter: int = 200,
    reltol: float = 1e-8,
):
    """Preconditioned MINRES for symmetric (indefinite) systems; the
    preconditioner must be SPD.  The JAX package's recurrence as a Python
    loop with host scalars (one synchronisation per iteration); returns
    (x, n_iterations, preconditioned residual norm)."""
    if preconditioner is None:
        preconditioner = lambda r: r

    def dot(a, c) -> float:
        return float(torch.sum(a * c))

    v_old, v = torch.zeros_like(b), b
    z = preconditioner(v)
    gamma = float(np.sqrt(dot(v, z)))
    gamma0 = eta = gamma_old = gamma
    s_old = s = 0.0
    c_old = c = 1.0
    w, w_old, x = torch.zeros_like(b), torch.zeros_like(b), torch.zeros_like(b)
    it = 0
    while abs(eta) > reltol * gamma0 and it < maxiter:
        z_n = z / gamma
        Az = a_vmult(z_n)
        delta = dot(Az, z_n)
        v_new = Az - (delta / gamma) * v - (gamma / gamma_old) * v_old
        z_new = preconditioner(v_new)
        gamma_new = float(np.sqrt(max(dot(v_new, z_new), 1e-300)))
        a0 = c * delta - c_old * s * gamma
        a1 = float(np.sqrt(a0 * a0 + gamma_new * gamma_new))
        a2 = s * delta + c_old * c * gamma
        a3 = s_old * gamma
        c_new, s_new = a0 / a1, gamma_new / a1
        w_new = (z_n - a3 * w_old - a2 * w) / a1
        x = x + (c_new * eta) * w_new
        eta = -s_new * eta
        v_old, v, z = v, v_new, z_new
        w_old, w = w, w_new
        gamma_old, gamma = gamma, gamma_new
        s_old, s, c_old, c = s, s_new, c, c_new
        it += 1
    return x, it, abs(eta)


def assemble_pressure_mass(
    dofh_p: DoFHandler, cell_weights: np.ndarray | None = None
) -> sp.csr_matrix:
    """Consistent Q_k pressure mass matrix (per-cell tensor products of 1D
    integrals, exact on the uniform hexahedral mesh).  ``cell_weights``
    multiplies per cell (the 1/viscosity weighting of a variable-viscosity
    Schur approximation)."""
    mesh = dofh_p.mesh
    n1 = dofh_p.degree + 1
    q, w = tensor.gauss_points(n1)
    lv = tensor.lagrange_values(tensor.gauss_lobatto_points(n1), q)
    M1 = np.einsum("q,qa,qb->ab", w, lv, lv)
    Mloc = np.einsum("ad,be,cf->abcdef", M1, M1, M1).reshape(n1**3, n1**3)
    h3 = np.broadcast_to(np.asarray(mesh.h(mesh.level)) ** 3, (dofh_p.cell_dofs.shape[0],))
    if cell_weights is not None:
        h3 = h3 * np.asarray(cell_weights, np.float64)
    rows = np.repeat(dofh_p.cell_dofs, n1**3, axis=1).reshape(-1)
    cols = np.tile(dofh_p.cell_dofs, (1, n1**3)).reshape(-1)
    vals = np.einsum("c,ab->cab", h3, Mloc).reshape(-1)
    M = sp.csr_matrix((vals, (rows, cols)), shape=(dofh_p.n_dofs, dofh_p.n_dofs))
    M.sum_duplicates()
    return M


def make_mass_solve(
    Mp: sp.csr_matrix, dtype: torch.dtype, device: torch.device, degree: int = 8
) -> ChebyshevSmoother:
    """Chebyshev approximation of M_p^{-1} (diagonal-preconditioned): for
    the Q1 mass on uniform hexahedra eig(D^{-1} M) lies in [1/8, 27/8] by
    tensor structure (1D: [1/2, 3/2], cubed), so a fixed degree gives a
    few-percent-accurate solve with ``degree`` ELL products and no
    eigenvalue estimate."""
    lam_max, lam_min = 27.0 / 8.0, 1.0 / 8.0
    return ChebyshevSmoother(
        op=MassOperator(_to_ell(Mp, dtype, device=device)),
        inv_diag=torch.as_tensor(1.0 / np.asarray(Mp.diagonal()), dtype=dtype, device=device),
        degree=degree,
        theta=0.5 * (lam_max + lam_min),
        delta=0.5 * (lam_max - lam_min),
    )


def build_stokes(
    mesh: AdaptiveMesh,
    mg_data,
    dtype: torch.dtype = torch.float64,
    mass_solver: str = "chebyshev",
    device: str | torch.device | None = None,
):
    """Assemble the Taylor-Hood Stokes system and its block-diagonal
    preconditioner on a uniform hypercube mesh, on ``device`` (None: the
    card).  Returns (op, precond, aux dict)."""
    device = resolve_device(device)
    assert mesh.dim == 3
    dofh_v = distribute_dofs(mesh, 2)
    dofh_p = distribute_dofs(mesh, 1)
    assert make_hanging_node_constraints(dofh_v).n_slaves == 0, (
        "Stokes: uniform (conforming) mesh"
    )

    # velocity GMG hierarchy (gather engine; hypercube => pure h-levels)
    plan = api.gc_level_plan("HMG-global", geometric_coarsening_sequence(mesh), 2)
    levels = [api.build_level(m, d, device, dtype) for m, d in plan]
    mg = api.build_gc_preconditioner(levels, mg_data)
    a_op = VectorOperator(levels[-1].op, 3)

    B = assemble_divergence(dofh_v, dofh_p)
    keep1 = np.ones(dofh_v.n_dofs)
    keep1[dofh_v.boundary_mask] = 0.0
    keep_v = torch.as_tensor(np.tile(keep1, 3), dtype=dtype, device=device)

    # Schur approximation S_hat = pressure mass.  "chebyshev" applies
    # ~M_p^{-1} with a fixed-interval Chebyshev on the consistent mass
    # (lumping alone stretches the preconditioned Schur interval ~2.5x:
    # block-diagonal MINRES 59 -> 96 outer iterations at r=2 in the JAX
    # package); "lumped" keeps the one-multiply row-sum inverse
    if mass_solver == "chebyshev":
        p_solve = make_mass_solve(assemble_pressure_mass(dofh_p), dtype, device)
    elif mass_solver == "lumped":
        lump = np.bincount(
            dofh_p.cell_dofs.reshape(-1),
            weights=np.repeat(mesh.h(mesh.level) ** 3 / 8.0, dofh_p.n_loc),
            minlength=dofh_p.n_dofs,
        )
        p_solve = LumpedMassSolve(torch.as_tensor(1.0 / lump, dtype=dtype, device=device))
    else:
        raise ValueError(f"unknown mass solver {mass_solver!r}")

    op = StokesOperator(
        a_op=a_op,
        B=_to_ell(B, dtype, device=device),
        Bt=_to_ell(B.T.tocsr(), dtype, device=device),
        keep_v=keep_v,
        n_v=dofh_v.n_dofs,
        n_p=dofh_p.n_dofs,
    )
    precond = StokesBlockPreconditioner(
        v_precond=PreconditionMG(mg, dtype), p_solve=p_solve,
        n_v=dofh_v.n_dofs, n_p=dofh_p.n_dofs,
    )
    aux = {"dofh_v": dofh_v, "dofh_p": dofh_p, "B": B, "levels": levels}
    return op, precond, aux


def triangular_preconditioner(
    op: StokesOperator, block: StokesBlockPreconditioner
) -> StokesTriangularPreconditioner:
    """The block-triangular preconditioner from the block-diagonal one's
    blocks (no extra set-up)."""
    return StokesTriangularPreconditioner(
        v_precond=block.v_precond, p_solve=block.p_solve, Bt=op.Bt,
        keep_v=op.keep_v, n_v=op.n_v, n_p=op.n_p,
    )


def project_pressure_mean(x: torch.Tensor, n_v: int, n_p: int) -> torch.Tensor:
    """Remove the hydrostatic (constant) pressure mode."""
    out = x.clone()
    p = out[3 * n_v :]
    out[3 * n_v :] = p - p.mean()
    return out
