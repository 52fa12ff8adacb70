"""Poisson model problems: right-hand sides and their hybrid-layout assembly.

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
from ..ops.operator import split_boundary_constraints

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


@dataclass
class PoissonProblem:
    """An assembled Poisson problem on one DoFHandler (global layout)."""

    dofh: DoFHandler
    rhs: torch.Tensor        # constrained system RHS (zeros on constrained DoFs)
    lift: np.ndarray         # x0: Dirichlet inhomogeneity, hanging-distributed
    exact_fn: Callable | None


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
    mesh, dim, p = dofh.mesh, dofh.dim, dofh.degree
    if simulation_type == "Constant":
        rhs_fn, bc_np, exact_fn = constant_rhs, None, None
    elif simulation_type == "Gaussian":
        rhs_fn, bc_np, exact_fn = gaussian_rhs, gaussian_solution, gaussian_solution
    else:
        raise ValueError(f"unknown SimulationType {simulation_type!r}")

    B3, qp, qw = element.quadrature_tables(dim, p)
    size = 1.0 / (1 << mesh.level.astype(np.int64))
    lo = mesh.lower + (mesh.upper - mesh.lower) * mesh.anchor * size[:, None]
    h = mesh.h(mesh.level)

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
    cslot = torch.as_tensor(cell_slots.reshape(-1), dtype=torch.int64, device=device)
    raw = torch.zeros(hop.n_slots, dtype=dtype, device=device)
    raw.index_add_(0, cslot, b_cell.reshape(-1))
    if np.any(x0):
        raw = raw - hop.cell_apply_raw(dev(fmt.from_global(x0)))
    r = hop.apply_ct_faces(raw)
    r = hop.exchange(r)
    r = hop.apply_ct(r)
    rhs_slots = r * hop.constrained_keep
    rep = torch.as_tensor(fmt.rep_slot, dtype=torch.int64, device=device)
    problem = PoissonProblem(dofh, rhs_slots[rep], x0, exact_fn)
    return problem, rhs_slots
