"""Flexible right-preconditioned restarted GMRES(m), on torch.

Mirror of the JAX package's solvers/gmres.py (deal.II SolverFGMRES's role:
the nonsymmetric, block-triangular-preconditioned saddle solves of the
Stokes model, models/stokes.py).  The Arnoldi basis is one ``[m+1, n]``
tensor; each step orthogonalises against the rows so far with two passes
of two GEMVs (classical Gram-Schmidt twice), and the Hessenberg / Givens
bookkeeping runs on the host in float64, one transfer per step.

Right preconditioning keeps the residual the true residual.  The variant
is FLEXIBLE (Saad 1993): the preconditioned vectors z_j = M v_j are stored
and the update is x += Z y, not x += M(V y).  A multigrid M with float32
levels inside a float64 solve is linear only to ~1e-10 relative, and plain
right preconditioning lets that error break the agreement between the
Givens residual and the true residual by orders of magnitude over a
restart cycle (120x on the n-sinker row of the JAX package); FGMRES makes
the recurrence exact for whatever M did, at the cost of an ``[m, n]``
buffer.  ``verify_true_residual`` recomputes ||b - A x|| after a solve and
raises where it contradicts the claimed residual.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch


class GMRESResult(NamedTuple):
    x: torch.Tensor
    n_iterations: int       # total Arnoldi steps across restarts
    residual_norm: float
    converged: bool


def _arnoldi_cycle(a_vmult, b, x0, preconditioner, m: int, tol: float):
    """One restart cycle from iterate x0; returns (x, steps, residual)."""
    r = b - a_vmult(x0)
    beta = float(torch.sqrt(torch.sum(r * r)))
    V = b.new_zeros((m + 1, b.shape[0]))
    V[0] = r / beta if beta > 0 else r
    Z = b.new_zeros((m, b.shape[0]))  # flexible: the stored M v_j
    H = np.zeros((m + 1, m))
    cs, sn = np.zeros(m), np.zeros(m)
    g = np.zeros(m + 1)
    g[0] = beta
    j, res = 0, beta
    while res > tol and j < m:
        Z[j] = preconditioner(V[j])
        w = a_vmult(Z[j])
        Vj = V[: j + 1]
        h = Vj @ w
        w = w - h @ Vj
        # one re-orthogonalisation pass (classical twice = numerically
        # modified): cheap insurance at m ~ 30
        h2 = Vj @ w
        w = w - h2 @ Vj
        hnext = torch.sqrt(torch.sum(w * w))
        V[j + 1] = w / torch.clamp(hnext, min=1e-300)
        col = np.zeros(m + 1)
        col[: j + 2] = torch.cat([h + h2, hnext[None]]).cpu().numpy()
        # the accumulated Givens rotations, then a new one for col[j+1]
        for i in range(j):
            col[i], col[i + 1] = (cs[i] * col[i] + sn[i] * col[i + 1],
                                  -sn[i] * col[i] + cs[i] * col[i + 1])
        rr = math.sqrt(col[j] * col[j] + col[j + 1] * col[j + 1])
        cs[j] = col[j] / rr if rr > 0 else 1.0
        sn[j] = col[j + 1] / rr if rr > 0 else 0.0
        col[j], col[j + 1] = rr, 0.0
        g[j + 1] = -sn[j] * g[j]
        g[j] = cs[j] * g[j]
        H[:, j] = col
        j += 1
        res = abs(g[j])
    if j == 0:
        return x0, 0, res
    y = scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
    # flexible update: the stored z_j, not M(V y)
    return x0 + torch.as_tensor(y, dtype=b.dtype, device=b.device) @ Z[:j], j, res


def gmres_solve(
    a_vmult: Callable,
    b: torch.Tensor,
    preconditioner: Callable | None = None,
    m: int = 30,
    maxiter: int = 1000,
    abstol: float = 1e-50,
    reltol: float = 1e-8,
) -> GMRESResult:
    """Solve A x = b by FGMRES(m) with right preconditioner M (identity if
    None) from x0 = 0.  Stops when the residual satisfies
    ||b - A x|| <= max(abstol, reltol * ||b||) (ReductionControl
    semantics), after ``maxiter`` total Arnoldi steps (checked between
    restart cycles, as the JAX package does), or when a restart cycle makes
    no progress."""
    if preconditioner is None:
        preconditioner = lambda r: r
    norm_b = float(torch.sqrt(torch.sum(b * b)))
    tol = max(abstol, reltol * norm_b)
    x = torch.zeros_like(b)
    it, res = 0, norm_b
    while res > tol and it < maxiter:
        x, j, res_new = _arnoldi_cycle(a_vmult, b, x, preconditioner, m, tol)
        # a cycle without progress cannot improve on restart: stop
        stall = j == 0 or res_new >= res
        it, res = it + j, res_new
        if stall:
            break
    return GMRESResult(x, it, res, res <= tol)


@dataclass(frozen=True)
class IdentityPreconditioner:
    def vmult(self, r: torch.Tensor) -> torch.Tensor:
        return r

    __call__ = vmult


def verify_true_residual(fop, b: torch.Tensor, x: torch.Tensor, claimed_res: float,
                         reltol: float, abstol: float = 1e-50,
                         context: str = "gmres") -> float:
    """Recompute ||b - A x|| and require agreement with the solver's claimed
    residual, allowing for the floor the operator's precision puts under
    the attainable true residual (~eps_op * ||b||).  Returns the true
    residual; raises RuntimeError on disagreement beyond 10x + floor."""
    r = b - fop.vmult(x)
    true_res = float(torch.sqrt(torch.sum(r * r)))
    norm_b = float(torch.sqrt(torch.sum(b * b)))
    floor = 1e4 * torch.finfo(getattr(fop, "dtype", b.dtype)).eps * norm_b
    threshold = 10.0 * max(abstol, reltol * norm_b, float(claimed_res)) + floor
    if not true_res <= threshold:
        raise RuntimeError(
            f"{context}: the recurrence residual disagrees with the recomputed "
            f"true residual (claimed {float(claimed_res):.3e} vs true "
            f"{true_res:.3e}, ||b|| {norm_b:.3e}, allowance {threshold:.3e}): "
            "the operator or preconditioner computed an inconsistent state"
        )
    return true_res
