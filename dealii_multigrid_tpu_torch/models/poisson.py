"""Poisson model problems: right-hand sides and their assembly on both engines.

The reference's simulation types (multigrid_throughput.cc:2286-2303):
  * "Constant": f = 1, homogeneous Dirichlet BC;
  * "Gaussian": manufactured Gaussian solution centred at (-0.5, ..., -0.5)
    with width 0.1 (multigrid_throughput.cc:60-127), inhomogeneous
    Dirichlet BC.
RHS assembly follows Operator::rhs (include/operator.h:362-447).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..mesh.dof import Constraints, DoFHandler
from ..ops import element
from ..ops.operator import LaplaceOperator, distribute, split_boundary_constraints

_WIDTH = 0.1
_CENTER = -0.5


def gaussian_solution(x):
    """Reference GaussianSolution::value; ``x`` [..., dim], NumPy or torch."""
    xp = torch if isinstance(x, torch.Tensor) else np
    dim = x.shape[-1]
    d2 = xp.sum((x - _CENTER) ** 2, -1)
    norm = (math.sqrt(2.0 * math.pi) * _WIDTH) ** dim
    return xp.exp(-d2 / (_WIDTH * _WIDTH)) / norm


def gaussian_rhs(x: torch.Tensor) -> torch.Tensor:
    """Reference GaussianRightHandSide::value (= -laplacian of the solution)."""
    dim = x.shape[-1]
    d2 = torch.sum((x - _CENTER) ** 2, -1)
    w2 = _WIDTH * _WIDTH
    norm = (math.sqrt(2.0 * math.pi) * _WIDTH) ** dim
    return ((2 * dim - 4 * d2 / w2) / w2) * torch.exp(-d2 / w2) / norm


def constant_rhs(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def zero_fn(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)


@dataclass
class PoissonProblem:
    """An assembled Poisson problem on one DoFHandler (global layout)."""

    dofh: DoFHandler
    rhs: torch.Tensor        # constrained system RHS (zeros on constrained DoFs)
    lift: np.ndarray         # x0: Dirichlet inhomogeneity, hanging-distributed
    exact_fn: Callable | None
    hanging: Constraints     # hanging rows off the Dirichlet boundary

    def full_solution(self, u_hom) -> np.ndarray:
        """Physical solution on the host, float64: distribute the hanging
        nodes over (u + lift) (AffineConstraints::distribute)."""
        u = np.asarray(torch.as_tensor(u_hom).cpu(), dtype=np.float64) + self.lift
        h = self.hanging
        if len(h.slave):
            u[h.slave] = (h.weights * u[h.masters]).sum(axis=1)
        return u


def _cell_geometry(dofh: DoFHandler):
    """Host tables of the cell quadrature: (B3 [nq, nloc], reference points
    qp [nq, dim], weights qw [nq], cell lower corners lo [nc, dim], cell
    widths h [nc])."""
    mesh = dofh.mesh
    B3, qp, qw = element.quadrature_tables(dofh.dim, dofh.degree)
    size = 1.0 / (1 << mesh.level.astype(np.int64))
    lo = mesh.lower + (mesh.upper - mesh.lower) * mesh.anchor * size[:, None]
    return B3, qp, qw, lo, mesh.h(mesh.level)


def l2_error(problem: PoissonProblem, u_full: np.ndarray) -> float:
    """Quadrature L2 norm of (u_h - u_exact) over the mesh, on the host in
    float64 from the cell DoFs (``u_full`` from ``full_solution``)."""
    dofh = problem.dofh
    B3, qp, qw, lo, h = _cell_geometry(dofh)
    pts = lo[:, None, :] + h[:, None, None] * qp[None, :, :]
    jxw = (h[:, None] ** dofh.dim) * qw[None, :]
    uq = np.asarray(u_full, np.float64)[dofh.cell_dofs] @ B3.T          # [nc, nq]
    eq = uq - problem.exact_fn(pts)
    return float(np.sqrt(np.sum(eq * eq * jxw)))


def assemble_problem(
    dofh: DoFHandler,
    hanging: Constraints,
    op: LaplaceOperator,
    rhs_fn: Callable,
    bc_fn: Callable,
    exact_fn: Callable | None = None,
) -> PoissonProblem:
    """RHS and inhomogeneity lift on the gather engine, in the global layout
    (reference: operator.h:362-447)."""
    dtype, device = op.dtype, op.device
    B3, qp, qw, lo, h = _cell_geometry(dofh)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    lo_d, h_d, qp_d, qw_d = dev(lo), dev(h), dev(qp), dev(qw)
    pts = lo_d[:, None, :] + h_d[:, None, None] * qp_d[None, :, :]
    jxw = (h_d[:, None] ** dofh.dim) * qw_d[None, :]
    # raw cell integrals of f * phi
    b_cell = torch.matmul(rhs_fn(pts) * jxw, dev(B3))              # [nc, nloc]
    F = op.cell_sum.scatter(b_cell.reshape(-1))
    # Dirichlet lift: x0 interpolates g on the boundary, then hanging
    # distribution makes it a conforming FE function
    x0 = torch.zeros(dofh.n_dofs, dtype=dtype, device=device)
    x0[op.dirichlet] = bc_fn(dev(dofh.points)[op.dirichlet])
    x0 = distribute(x0, op.hanging)
    # constrained RHS: C^T (F - A_raw x0), zero on constrained DoFs
    b = op.apply_ct(F - op.cell_apply_raw(x0))
    b[op.constrained] = 0
    hang, _ = split_boundary_constraints(dofh, hanging)
    return PoissonProblem(dofh, b, x0.double().cpu().numpy(), exact_fn, hang)


def make_problem(
    dofh: DoFHandler,
    hanging: Constraints,
    op: LaplaceOperator,
    simulation_type: str = "Constant",
) -> PoissonProblem:
    """Dispatch by SimulationType config key (multigrid_throughput.cc:2286-2303)."""
    if simulation_type == "Constant":
        return assemble_problem(dofh, hanging, op, constant_rhs, zero_fn, None)
    if simulation_type == "Gaussian":
        return assemble_problem(
            dofh, hanging, op, gaussian_rhs, gaussian_solution, gaussian_solution
        )
    raise ValueError(f"unknown SimulationType {simulation_type!r}")


def assemble_problem_hybrid(
    dofh: DoFHandler,
    hanging: Constraints,
    hop,                       # HybridOperator in the OUTER precision
    cell_slots: np.ndarray,    # [n_cells, n_loc] slot id per cell node
    fmt,                       # HybridFormat (from_global / rep_slot)
    simulation_type: str = "Constant",
) -> tuple[PoissonProblem, torch.Tensor]:
    """RHS assembly on the hybrid patch engine.

    Returns ``(problem, rhs_slots)`` with ``rhs_slots`` in the hybrid slot
    layout.  The per-cell quadrature integrals land in each cell's own
    slots (raw, pre-exchange), so the operator's apply_ct_faces -> exchange
    -> apply_ct pipeline performs C^T exactly as in a vmult; the Dirichlet
    lift x0 is built on the host.
    """
    dtype, device = hop.dtype, hop.device
    dim = dofh.dim
    if simulation_type == "Constant":
        rhs_fn, bc_np, exact_fn = constant_rhs, None, None
    elif simulation_type == "Gaussian":
        rhs_fn, bc_np, exact_fn = gaussian_rhs, gaussian_solution, gaussian_solution
    else:
        raise ValueError(f"unknown SimulationType {simulation_type!r}")

    B3, qp, qw, lo, h = _cell_geometry(dofh)

    # host: Dirichlet inhomogeneity lift x0 (hanging-distributed, global)
    hang, dirichlet = split_boundary_constraints(dofh, hanging)
    x0 = np.zeros(dofh.n_dofs)
    if bc_np is not None and len(dirichlet):
        x0[dirichlet] = bc_np(dofh.points[dirichlet])
    if len(hang.slave):
        x0[hang.slave] = (hang.weights * x0[hang.masters]).sum(axis=1)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    lo_d, h_d, qp_d, qw_d, B3_d = dev(lo), dev(h), dev(qp), dev(qw), dev(B3)
    pts = lo_d[:, None, :] + h_d[:, None, None] * qp_d[None, :, :]
    jxw = (h_d[:, None] ** dim) * qw_d[None, :]
    b_cell = torch.matmul(rhs_fn(pts) * jxw, B3_d)               # [nc, nloc]
    # the cell-to-slot targets repeat inside a patch: the host sums them in
    # float64 in one fixed order (index_add_ on the card would not)
    raw = dev(np.bincount(
        cell_slots.reshape(-1), weights=b_cell.reshape(-1).cpu().numpy(), minlength=hop.n_slots
    ))
    del b_cell
    if np.any(x0):
        raw = raw - hop.cell_apply_raw(dev(fmt.from_global(x0)))
    r = hop.apply_ct_faces(raw)
    r = hop.exchange(r)
    r = hop.apply_ct(r)
    rhs_slots = r * hop.constrained_keep
    rep = torch.as_tensor(fmt.rep_slot, dtype=torch.int64, device=device)
    problem = PoissonProblem(dofh, rhs_slots[rep], x0, exact_fn, hang)
    return problem, rhs_slots
