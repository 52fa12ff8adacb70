"""Preconditioned conjugate gradients with deal.II ReductionControl semantics.

Mirrors SolverCG + ReductionControl (reference: multigrid_throughput.cc:
1143-1145, 1238-1254): stop when ||r|| <= max(abstol, reltol * ||r0||) and
report the iteration count.  A Python loop over torch tensors; the only
host synchronisation per iteration is the convergence test.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    n_iterations: int
    residual_norm: float
    converged: bool
    norm0: float  # ||r0|| (= ||b|| for x0 = 0); input of the residual guard


def cg_solve(
    a_vmult: Callable,
    b: torch.Tensor,
    preconditioner: Callable | None = None,
    maxiter: int = 10000,
    abstol: float = 1e-20,
    reltol: float = 1e-4,
    force_iterations: int | None = None,
    dot: Callable | None = None,
) -> CGResult:
    """Solve A x = b by PCG from x0 = 0.

    deal.II SolverCG ordering (solver_cg.h): the preconditioner applies at
    the START of an iteration, AFTER the convergence test on the fresh
    residual, so a converged solve does exactly n_it M-applies; beta is 0
    on the first iteration.  ``force_iterations`` runs exactly that many
    iterations (the reference's parameter-study mode).
    """
    if preconditioner is None:
        preconditioner = lambda r: r
    if dot is None:
        dot = lambda u, v: torch.sum(u * v)
    x = torch.zeros_like(b)
    r = b.clone()
    p = torch.zeros_like(b)
    rz = dot(r, r)
    norm0 = float(torch.sqrt(rz))
    if force_iterations is not None:
        tol, maxiter = 0.0, force_iterations
    else:
        tol = max(abstol, reltol * norm0)
    res = norm0
    it = 0
    while res > tol and it < maxiter:
        z = preconditioner(r)
        rz_new = dot(r, z)
        if it > 0:
            p = z + (rz_new / rz) * p
        else:
            p = z
        ap = a_vmult(p)
        alpha = rz_new / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz = rz_new
        it += 1
        res = float(torch.sqrt(dot(r, r)))
    return CGResult(x, it, res, res <= tol, norm0)
