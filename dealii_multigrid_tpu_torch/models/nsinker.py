"""Variable-viscosity Stokes: the n-sinker benchmark family, on torch.

Mirror of the JAX package's models/nsinker.py (the reference points its
mantle-convection workload at the n-sinker benchmark,
mantle-convection/README.md:1-25: n high-viscosity spherical inclusions
sinking in a low-viscosity medium):

  * viscous block: the cellwise-constant-coefficient vector Laplacian,
    ``ops/operator.make_operator(cell_weights=eta)`` (exact for a
    piecewise-constant viscosity);
  * velocity multigrid, two constructions (``coarsening``): "mean"
    re-discretizes every level with the fine viscosity averaged 8-to-1 down
    the Morton hierarchy; "galerkin" forms A_c = P^T A_f P on the host from
    the assembled fine matrix and the exact Q2 embedding, applies the coarse
    levels and transfers as ELL products, and keeps the finest level
    matrix-free;
  * Schur approximation (``schur``): "mass" is the 1/eta-weighted pressure
    mass under the fixed-interval Chebyshev of models/stokes.py; "wbfbt" is
    the scaled BFBT approximation with an AMG-preconditioned CG on
    Kp = B D^-1 B^T;
  * outer solve: FGMRES with the block upper-triangular preconditioner
    (solvers/gmres.py, models/stokes.py).

Host set-up is NumPy and SciPy, as in the JAX package; every table, diagonal
and factor lands on the caller's device (None: the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from .. import api
from ..mesh.coarsening import geometric_coarsening_sequence
from ..mesh.dof import DoFHandler, distribute_dofs, local_node_indices, make_hanging_node_constraints
from ..mesh.octree import AdaptiveMesh
from ..ops import tensor
from ..ops.operator import compute_diagonal, make_operator
from ..ops.vector import VectorOperator
from ..solvers.amg import ELLMatrix, _to_ell, build_amg
from ..solvers.cg import cg_solve
from ..solvers.chebyshev import ChebyshevSmoother, estimate_eigenvalue_ranges
from ..solvers.coarse import DirectCoarseSolver, assemble_sparse_matrix
from ..solvers.multigrid import Multigrid, PreconditionMG
from ..utils.device import resolve_device
from ..utils.phases import SETUP, checked
from .stokes import (
    StokesBlockPreconditioner,
    StokesOperator,
    assemble_divergence,
    assemble_pressure_mass,
    make_mass_solve,
)


def nsinker_viscosity(
    n_sinkers: int = 4,
    eta_min: float = 1.0,
    eta_max: float = 1e3,
    radius: float = 0.7,
    delta: float = 50.0,
    seed: int = 0,
):
    """Smoothed n-sinker viscosity field on [-1, 1]^3 (the pTatin/May
    benchmark shape): eta = eta_max inside the inclusions, eta_min outside,
    with an exp-smoothed transition of decay rate ``delta``."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.55, 0.55, size=(n_sinkers, 3))

    def eta(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        m = np.ones(x.shape[0])
        for c in centers:
            d = np.linalg.norm(x - c[None, :], axis=1)
            m *= 1.0 - np.exp(-delta * np.maximum(0.0, d - radius / 2.0) ** 2)
        return eta_min * m + eta_max * (1.0 - m)

    eta.centers = centers
    return eta


@dataclass(frozen=True)
class ELLOperator:
    """Scalar level operator from an assembled (Galerkin) sparse matrix: the
    matrix-dependent coarse-grid component for high-contrast viscosity."""

    M: ELLMatrix
    n_dofs: int

    @property
    def dtype(self) -> torch.dtype:
        return self.M.vals.dtype

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        return self.M.matvec(x)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sum(x * y)


@dataclass(frozen=True)
class SparseTransfer:
    """Level transfer from an assembled prolongation: prolong = P u,
    restrict = P^T r through P^T's own ELL table (a gather and a row sum,
    so a restriction sums in one order on every run)."""

    P: ELLMatrix    # [n_fine, n_coarse]
    Pt: ELLMatrix   # [n_coarse, n_fine]

    def prolong(self, u: torch.Tensor) -> torch.Tensor:
        return self.P.matvec(u)

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        return self.Pt.matvec(r)


def assemble_prolongation(dofh_f: DoFHandler, dofh_c: DoFHandler) -> sp.csr_matrix:
    """Sparse Q_p embedding P [n_fine, n_coarse] between two conforming
    uniform meshes where fine cells 8j..8j+7 are the Morton children of
    coarse cell j.

    Dirichlet rows (fine) and columns (coarse) are zeroed: the level
    operators keep the identity on constrained rows, so boundary values
    neither restrict nor prolongate (deal.II MGConstrainedDoFs semantics)."""
    p = dofh_f.degree
    if dofh_c.degree != p:
        raise ValueError("assemble_prolongation: both levels must have one degree")
    mesh_f, mesh_c = dofh_f.mesh, dofh_c.mesh
    nloc = dofh_f.n_loc
    E = tensor.h_embedding_1d(p)               # E[b][i, j] = l_j((x_i+b)/2)
    loc = local_node_indices(3, p)             # [nloc, 3], x fastest
    # W[b][i, j] = prod_d E[b_d][i_d, j_d] for the 8 child positions
    W = np.empty((2, 2, 2, nloc, nloc))
    for bx in range(2):
        for by in range(2):
            for bz in range(2):
                W[bx, by, bz] = (
                    E[bx][loc[:, None, 0], loc[None, :, 0]]
                    * E[by][loc[:, None, 1], loc[None, :, 1]]
                    * E[bz][loc[:, None, 2], loc[None, :, 2]]
                )

    parent = np.arange(mesh_f.n_cells) // 8
    b = np.asarray(mesh_f.anchor) - 2 * np.asarray(mesh_c.anchor)[parent]
    if b.min() < 0 or b.max() > 1:
        raise ValueError("assemble_prolongation: not a Morton children hierarchy")

    # one interpolation row per fine DoF, from its first (cell, node)
    # occurrence (duplicates agree: the embedding is single-valued on
    # conforming meshes)
    flat = dofh_f.cell_dofs.reshape(-1).astype(np.int64)
    _, first = np.unique(flat, return_index=True)
    cell = first // nloc
    node = first % nloc
    rows = flat[first]                                  # == arange(n_dofs)
    masters = dofh_c.cell_dofs[parent[cell]].astype(np.int64)  # [n, nloc]
    weights = W[b[cell, 0], b[cell, 1], b[cell, 2], node]      # [n, nloc]
    # boundary elimination: rows (fine Dirichlet) and columns (coarse Dirichlet)
    weights = np.where(dofh_f.boundary_mask[rows][:, None], 0.0, weights)
    weights = np.where(dofh_c.boundary_mask[masters], 0.0, weights)
    nz = np.abs(weights) > 1e-14
    r_idx = np.repeat(rows, nloc).reshape(-1, nloc)[nz]
    P = sp.csr_matrix(
        (weights[nz], (r_idx, masters[nz])),
        shape=(dofh_f.n_dofs, dofh_c.n_dofs),
    )
    P.sum_duplicates()
    return P


def _mean_ladder(eta_fine: np.ndarray, n_levels: int) -> list:
    """The fine cell viscosity averaged 8-to-1 down the hierarchy (the
    uniform hypercube's Morton order makes children the 8 consecutive cells
    of each parent), coarsest first.  Arithmetic averaging beats point
    re-sampling 1.6-2x in outer iterations at contrast 1e3-1e4 in the JAX
    package; harmonic averaging loses the stiff inclusions."""
    etas = [np.asarray(eta_fine, np.float64)]
    for _ in range(n_levels - 1):
        etas.append(etas[-1].reshape(-1, 8).mean(1))
    return etas[::-1]


def _mean_hierarchy(geo: list, eta_fine: np.ndarray, mg_data, device: torch.device,
                    dtype: torch.dtype):
    """(levels, Multigrid) of the re-discretized velocity hierarchy: each
    level of ``geo`` (mesh, degree, dofh, hanging; coarsest first, built
    once) carries the fine viscosity averaged down to its cells."""
    levels = []
    for (m, d, dofh, hanging), eta_cells in zip(geo, _mean_ladder(eta_fine, len(geo))):
        op = make_operator(dofh, hanging, device, dtype, cell_weights=eta_cells)
        inv_diag = torch.as_tensor(
            1.0 / compute_diagonal(dofh, hanging, cell_weights=eta_cells), dtype=dtype, device=device
        )
        levels.append(api.LevelContext(m, d, dofh, hanging, op, inv_diag))
    return levels, api.build_gc_preconditioner(levels, mg_data)


def _velocity_geometry(mesh: AdaptiveMesh):
    """(dofh_v, dofh_p, level geometries coarsest first) of the Q2-Q1 pair
    on a uniform conforming hypercube mesh."""
    if mesh.dim != 3:
        raise ValueError("the n-sinker model is three-dimensional")
    dofh_v = distribute_dofs(mesh, 2)
    dofh_p = distribute_dofs(mesh, 1)
    if make_hanging_node_constraints(dofh_v).n_slaves:
        raise ValueError("the n-sinker model needs a uniform (conforming) mesh")
    plan = api.gc_level_plan("HMG-global", geometric_coarsening_sequence(mesh), 2)
    geo = []
    for m, d in plan:
        dofh = distribute_dofs(m, d)
        geo.append((m, d, dofh, make_hanging_node_constraints(dofh)))
    return dofh_v, dofh_p, geo


def _keep1(dofh_v: DoFHandler) -> np.ndarray:
    keep1 = np.ones(dofh_v.n_dofs)
    keep1[dofh_v.boundary_mask] = 0.0
    return keep1


@dataclass
class StokesRebuilder:
    """``rebuild(eta_fine) -> (op, block_preconditioner)``: the geometry
    (DoFs, constraints, B, B^T) is built once by ``make_stokes_rebuilder``,
    and each call swaps the viscosity (mean-coarsened hierarchy, 1/eta
    weighted pressure mass), for loops whose viscosity changes every step
    (the temperature-dependent rheology of the convection demo)."""

    mg_data: object
    dtype: torch.dtype
    device: torch.device
    dofh_v: DoFHandler
    dofh_p: DoFHandler
    geo: list
    B: ELLMatrix
    Bt: ELLMatrix
    keep_v: torch.Tensor

    def __call__(self, eta_fine: np.ndarray):
        eta_fine = np.asarray(eta_fine, np.float64)
        levels, mg = _mean_hierarchy(self.geo, eta_fine, self.mg_data, self.device, self.dtype)
        n_v, n_p = self.dofh_v.n_dofs, self.dofh_p.n_dofs
        op = StokesOperator(
            a_op=VectorOperator(levels[-1].op, 3),
            B=self.B, Bt=self.Bt, keep_v=self.keep_v, n_v=n_v, n_p=n_p,
        )
        precond = StokesBlockPreconditioner(
            v_precond=checked(PreconditionMG(mg, self.dtype)),
            p_solve=checked(make_mass_solve(
                assemble_pressure_mass(self.dofh_p, cell_weights=1.0 / eta_fine),
                self.dtype, self.device,
            ), "schur"),
            n_v=n_v, n_p=n_p,
        )
        return op, precond


def make_stokes_rebuilder(
    mesh: AdaptiveMesh, mg_data, dtype: torch.dtype = torch.float64,
    device: str | torch.device | None = None,
) -> StokesRebuilder:
    """Geometry set-up once on ``device`` (None: the card); the returned
    rebuilder swaps the viscosity per call."""
    device = resolve_device(device)
    dofh_v, dofh_p, geo = _velocity_geometry(mesh)
    B = assemble_divergence(dofh_v, dofh_p)
    return StokesRebuilder(
        mg_data=mg_data, dtype=dtype, device=device, dofh_v=dofh_v, dofh_p=dofh_p,
        geo=geo,
        B=_to_ell(B, dtype, device=device),
        Bt=_to_ell(B.T.tocsr(), dtype, device=device),
        keep_v=torch.as_tensor(np.tile(_keep1(dofh_v), 3), dtype=dtype, device=device),
    )


@dataclass(frozen=True)
class WBFBTSchurSolve:
    """Scaled BFBT (w-BFBT) Schur approximation:

        S^-1 ~= Kp^-1 (B D^-1 A D^-1 B^T) Kp^-1,   Kp = B D^-1 B^T,

    with D = diag(A) (Rudi/Malossi/Stadler SC16: robust for sharp
    high-contrast viscosity, where the inverse-viscosity-weighted mass loses
    its spectral equivalence).  Kp is the Neumann pressure Laplacian analog,
    singular with the constant, so its mean is removed around each
    application."""

    kp_solve: object     # vmult: approximate Kp^-1 on [n_p]
    B: ELLMatrix         # [n_p, 3 n_v]
    Bt: ELLMatrix        # [3 n_v, n_p]
    a_op: VectorOperator  # [3, n_v] -> [3, n_v]
    dinv: torch.Tensor   # [3 n_v] = keep / diag(A)
    n_v: int

    def _kp(self, r: torch.Tensor) -> torch.Tensor:
        z = self.kp_solve.vmult(r - r.mean())
        return z - z.mean()

    def vmult(self, r: torch.Tensor) -> torch.Tensor:
        z1 = self._kp(r)
        u = self.Bt.matvec(z1) * self.dinv
        au = self.a_op.vmult(u.view(3, self.n_v)).reshape(-1)
        w = self.B.matvec(au * self.dinv)
        return self._kp(w)


@dataclass(frozen=True)
class KpCGSolve:
    """Fixed-iteration AMG-preconditioned CG on Kp, the inner Poisson solve
    of BFBT.  One AMG cycle alone is too weak on the high-contrast
    pressure Laplacian (the JAX package measured outer GMRES 300+
    iterations against 50 with an exact Kp solve at r=4, contrast 1e6);
    16-20 AMG-CG steps recover the exact-Kp count.  The residual-dependent
    CG coefficients make the preconditioner mildly nonlinear: pair it with
    flexible GMRES and verify_true_residual."""

    amg: object          # one-cycle AMGPreconditioner
    Kp: ELLMatrix
    n_it: int

    def vmult(self, r: torch.Tensor) -> torch.Tensor:
        return cg_solve(
            self.Kp.matvec, r, preconditioner=self.amg.vmult, force_iterations=self.n_it
        ).x


def make_wbfbt_schur(
    B_csr: sp.csr_matrix, a_op: VectorOperator, diag_A1: np.ndarray, keep1: np.ndarray,
    dtype: torch.dtype, device: torch.device, kp_cg_iterations: int = 20,
    seconds: dict | None = None,
) -> WBFBTSchurSolve:
    """The w-BFBT Schur solve from the assembled divergence matrix, the
    matrix-free velocity operator and the scalar velocity diagonal
    (``diag_A1`` and ``keep1`` per scalar component, [n_v]; the vector
    diagonal is their 3-fold tile).  Kp = B D^-1 B^T is assembled on the
    host; the tiny Tikhonov shift makes the AMG's coarsest dense Cholesky
    well-posed on the singular operator without affecting the projected
    application.  ``seconds`` receives the "kp", "amg_build" and
    "amg_upload" stages."""
    t0 = time.perf_counter()
    dinv1 = keep1 / np.asarray(diag_A1, np.float64)
    dinv = np.tile(dinv1, 3)
    Kp = (B_csr @ sp.diags(dinv) @ B_csr.T).tocsr()
    shift = 1e-10 * float(np.abs(Kp.diagonal()).max())
    t_kp = time.perf_counter() - t0
    stages = ("mgtpu.setup.amg_build", "mgtpu.setup.amg_upload", "mgtpu.setup.amg_factor")
    before = [SETUP.seconds(n) for n in stages]
    amg = build_amg(
        (Kp + shift * sp.eye(Kp.shape[0])).tocsr(), dtype=dtype, device=device, n_cycles=1
    )
    if seconds is not None:
        build, upload, factor = (SETUP.seconds(n) - t for n, t in zip(stages, before))
        seconds["kp"] = t_kp
        seconds["amg_build"] = build
        seconds["amg_upload"] = upload + factor
    return WBFBTSchurSolve(
        kp_solve=checked(KpCGSolve(amg, _to_ell(Kp, dtype, device=device), kp_cg_iterations), "kp"),
        B=_to_ell(B_csr, dtype, device=device),
        Bt=_to_ell(B_csr.T.tocsr(), dtype, device=device),
        a_op=a_op,
        dinv=torch.as_tensor(dinv, dtype=dtype, device=device),
        n_v=len(diag_A1),
    )


def _build_galerkin_velocity_mg(geo, eta_fine_cells: np.ndarray, mg_data, dtype: torch.dtype,
                                device: torch.device, seconds: dict) -> Multigrid:
    """Velocity-block Multigrid with Galerkin coarse operators
    A_{l-1} = P_l^T A_l P_l from the assembled fine matrix, exact Q2
    embedding transfers, Chebyshev smoothers on the true level diagonals
    and a dense-Cholesky coarsest solve.  The finest level stays
    matrix-free (the assembled A_f is a set-up artifact).  ``seconds``
    receives the stages "assemble_A", "triple_products", "upload" and
    "eigenvalues"."""
    L = len(geo)
    dofhs = [g[2] for g in geo]
    t0 = time.perf_counter()
    hang_f = geo[-1][3]
    fine_op = make_operator(dofhs[-1], hang_f, device, dtype, cell_weights=eta_fine_cells)
    fine_diag = compute_diagonal(dofhs[-1], hang_f, cell_weights=eta_fine_cells)
    A = assemble_sparse_matrix(dofhs[-1], hang_f, cell_weights=eta_fine_cells)
    t1 = time.perf_counter()
    mats = [None] * L
    mats[-1] = A
    Ps = [None] * L  # Ps[l]: level l-1 -> l
    for l in range(L - 1, 0, -1):
        P = assemble_prolongation(dofhs[l], dofhs[l - 1])
        Ac = (P.T @ mats[l] @ P).tocsr()
        # identity on coarse constrained rows (their P column is zeroed, so
        # the triple product leaves them empty)
        bnd = dofhs[l - 1].boundary_mask
        Ac = (Ac + sp.diags(bnd.astype(np.float64))).tocsr()
        if not (Ac.diagonal()[~bnd] > 0).all():
            raise RuntimeError(f"Galerkin level {l - 1}: a free row lost its positive diagonal")
        mats[l - 1] = Ac
        Ps[l] = P
    t2 = time.perf_counter()
    operators = tuple(
        ELLOperator(_to_ell(mats[l], dtype, device=device), dofhs[l].n_dofs) for l in range(L - 1)
    ) + (fine_op,)
    transfers = (None,) + tuple(
        SparseTransfer(_to_ell(Ps[l], dtype, device=device),
                       _to_ell(Ps[l].T.tocsr(), dtype, device=device))
        for l in range(1, L)
    )
    inv_diags = [None] + [
        torch.as_tensor(1.0 / (fine_diag if l == L - 1 else mats[l].diagonal()),
                        dtype=dtype, device=device)
        for l in range(1, L)
    ]
    coarse = DirectCoarseSolver(
        torch.as_tensor(np.linalg.cholesky(mats[0].toarray()), dtype=dtype, device=device)
    )
    api._fence(device)
    t3 = time.perf_counter()
    sm = mg_data.smoother
    ranges = estimate_eigenvalue_ranges(
        operators[1:], inv_diags[1:],
        None,
        n_iterations=sm.eig_cg_n_iterations,
    )
    smoothers = (None,) + tuple(
        ChebyshevSmoother.create(
            operators[l], inv_diags[l],
            max_eigenvalue=1.2 * ranges[l - 1][0],  # deal.II safety factor
            degree=sm.degree, smoothing_range=sm.smoothing_range,
        )
        for l in range(1, L)
    )
    seconds.update(assemble_A=t1 - t0, triple_products=t2 - t1, upload=t3 - t2,
                   eigenvalues=time.perf_counter() - t3)
    return Multigrid(operators=operators, smoothers=smoothers, transfers=transfers,
                     coarse_solve=coarse)


def build_stokes_nsinker(
    mesh: AdaptiveMesh, mg_data, viscosity, dtype: torch.dtype = torch.float64,
    coarsening: str = "mean", schur: str = "mass",
    device: str | torch.device | None = None,
):
    """Q2-Q1 Taylor-Hood Stokes with the cellwise viscosity ``viscosity``
    (callable: [n, 3] cell centres -> [n] eta) on ``device`` (None: the
    card).  Mirrors stokes.build_stokes; returns (op, block_preconditioner,
    aux), aux with the host set-up split in ``aux["setup_seconds"]``.

    ``coarsening``: "mean" re-discretizes every level with the viscosity
    averaged 8-to-1 (beats point sampling at contrast 1e3-1e4, loses the
    hierarchy at 1e5 and above); "galerkin" builds matrix-dependent coarse
    operators (the high-contrast regime, 1e6, of the reference's
    mantle-convection pointer).  ``schur``: "mass" or "wbfbt"."""
    if coarsening not in ("mean", "galerkin"):
        raise ValueError(f"unknown coarsening {coarsening!r}")
    if schur not in ("mass", "wbfbt"):
        raise ValueError(f"unknown Schur approximation {schur!r}")
    device = resolve_device(device)
    seconds: dict = {}
    t0 = time.perf_counter()
    dofh_v, dofh_p, geo = _velocity_geometry(mesh)
    eta_fine = np.asarray(viscosity(mesh.centers()), np.float64)
    seconds["geometry"] = time.perf_counter() - t0
    if coarsening == "galerkin":
        mg = _build_galerkin_velocity_mg(geo, eta_fine, mg_data, dtype, device, seconds)
        levels = None
        fine_op = mg.operators[-1]
    else:
        for fine, coarse in zip(geo[:0:-1], geo[-2::-1]):
            if not np.allclose(fine[0].centers().reshape(-1, 8, 3).mean(1), coarse[0].centers(),
                               atol=1e-12):
                raise ValueError("Morton 8-block / parent misalignment")
        t0 = time.perf_counter()
        levels, mg = _mean_hierarchy(geo, eta_fine, mg_data, device, dtype)
        seconds["levels"] = time.perf_counter() - t0
        fine_op = levels[-1].op
    a_op = VectorOperator(fine_op, 3)

    t0 = time.perf_counter()
    B = assemble_divergence(dofh_v, dofh_p)
    keep1 = _keep1(dofh_v)
    seconds["divergence"] = time.perf_counter() - t0
    if schur == "wbfbt":
        inv_diag_fine = (mg.smoothers[-1].inv_diag if levels is None else levels[-1].inv_diag)
        diag_A1 = 1.0 / inv_diag_fine.cpu().numpy().astype(np.float64)
        p_solve = make_wbfbt_schur(B, a_op, diag_A1, keep1, dtype, device, seconds=seconds)
    else:
        p_solve = make_mass_solve(
            assemble_pressure_mass(dofh_p, cell_weights=1.0 / eta_fine), dtype, device
        )

    op = StokesOperator(
        a_op=a_op,
        B=_to_ell(B, dtype, device=device),
        Bt=_to_ell(B.T.tocsr(), dtype, device=device),
        keep_v=torch.as_tensor(np.tile(keep1, 3), dtype=dtype, device=device),
        n_v=dofh_v.n_dofs,
        n_p=dofh_p.n_dofs,
    )
    precond = StokesBlockPreconditioner(
        v_precond=checked(PreconditionMG(mg, dtype)),
        p_solve=checked(p_solve, "schur"),
        n_v=dofh_v.n_dofs,
        n_p=dofh_p.n_dofs,
    )
    aux = {"dofh_v": dofh_v, "dofh_p": dofh_p, "B": B, "levels": levels,
           "eta_fine": eta_fine, "setup_seconds": seconds}
    return op, precond, aux
