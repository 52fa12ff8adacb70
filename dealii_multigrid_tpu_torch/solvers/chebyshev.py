"""Chebyshev-Jacobi smoother with CG-Lanczos eigenvalue estimation.

Mirror of deal.II's PreconditionChebyshev + DiagonalMatrix as the reference
uses them (multigrid_throughput.cc:849-883, 936-960): ``eig_cg_n_iterations``
Jacobi-preconditioned CG steps estimate the largest eigenvalue of D^{-1} A
(Lanczos tridiagonal from the CG coefficients, eigvalsh on the host), the
caller applies the 1.2 safety factor, and the smoother works on
[max_eig / smoothing_range, max_eig].  ``degree`` follows deal.II (degree 1
is damped Jacobi).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _extremes_from_cg_coefficients(alphas, betas) -> tuple[float, float]:
    """(lam_max, lam_min) of the Lanczos tridiagonal built from CG
    alphas/betas (host-side post-processing)."""
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    # truncate at CG breakdown (small problems converge in < n_iterations
    # steps, after which the coefficients are garbage / non-finite)
    ok = np.isfinite(alphas) & (alphas > 0) & np.isfinite(betas) & (betas >= 0)
    bad = np.nonzero(~ok)[0]
    k = int(bad[0]) if len(bad) else len(alphas)
    if k == 0:
        return 1.0, 1.0
    alphas, betas = alphas[:k], betas[:k]
    diag = np.empty(k)
    diag[0] = 1.0 / alphas[0]
    for i in range(1, k):
        diag[i] = 1.0 / alphas[i] + betas[i - 1] / alphas[i - 1]
    off = np.sqrt(np.maximum(betas[:-1], 0.0)) / alphas[:-1]
    T = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[-1]), float(ev[0])


def estimate_eigenvalue_range(
    op, inv_diag: torch.Tensor, b0: torch.Tensor, n_iterations: int = 20,
    use_op_dot: bool = False,
) -> tuple[float, float]:
    """Largest/smallest eigenvalue estimate of D^{-1} A via CG-Lanczos on
    the start vector ``b0``; one host transfer of the coefficients."""
    dot = op.dot if use_op_dot else (lambda a, c: torch.sum(a * c))
    r = b0.to(inv_diag.dtype)
    p = inv_diag * r
    rz = dot(r, p)
    alphas, betas = [], []
    for _ in range(n_iterations):
        ap = op.vmult(p)
        alpha = rz / dot(p, ap)
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        alphas.append(alpha)
        betas.append(beta)
    coeffs = torch.stack([torch.stack(alphas), torch.stack(betas)]).cpu().numpy()
    return _extremes_from_cg_coefficients(coeffs[0], coeffs[1])


def estimate_eigenvalue_ranges(
    ops, inv_diags, b0s, n_iterations: int = 20, use_op_dot: bool = False
) -> list[tuple[float, float]]:
    """Per-level estimates for a hierarchy; every level is estimated."""
    return [
        estimate_eigenvalue_range(op, d, b, n_iterations, use_op_dot)
        for op, d, b in zip(ops, inv_diags, b0s)
    ]


@dataclass(frozen=True)
class ChebyshevSmoother:
    """Degree-d Chebyshev polynomial smoother for D^{-1} A.

    vmult(b): apply with zero initial guess (MG pre-smoothing).
    step(x, b): apply with initial guess x (MG post-smoothing).
    """

    op: object
    inv_diag: torch.Tensor
    degree: int
    theta: float  # interval centre
    delta: float  # interval half-width

    @classmethod
    def create(
        cls,
        op,
        inv_diag: torch.Tensor,
        max_eigenvalue: float,
        degree: int = 5,
        smoothing_range: float = 20.0,
    ) -> "ChebyshevSmoother":
        min_eigenvalue = max_eigenvalue / smoothing_range
        theta = 0.5 * (max_eigenvalue + min_eigenvalue)
        delta = 0.5 * (max_eigenvalue - min_eigenvalue)
        return cls(op, inv_diag, degree, float(theta), float(delta))

    def _scalars(self, dtype: torch.dtype):
        # the reference computes the recurrence scalars in the vector dtype
        t = torch.tensor([self.theta, self.delta], dtype=dtype)
        theta, delta = t[0], t[1]
        return theta, delta, theta / delta

    def _recurrence(self, x, d, b, sigma, delta, n_steps):
        rho_old = 1.0 / sigma
        for _ in range(n_steps):
            r = b - self.op.vmult(x)
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * (self.inv_diag * r)
            x = x + d
            rho_old = rho
        return x

    def step(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Chebyshev iteration from initial guess x (three-term recurrence)."""
        theta, delta, sigma = self._scalars(b.dtype)
        r = b - self.op.vmult(x)
        d = (self.inv_diag * r) / float(theta)
        return self._recurrence(x + d, d, b, sigma, delta, self.degree - 1)

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        """Apply as a preconditioner (zero initial guess); saves the first
        operator application since r0 = b."""
        theta, delta, sigma = self._scalars(b.dtype)
        d = (self.inv_diag * b) / float(theta)
        return self._recurrence(d, d, b, sigma, delta, self.degree - 1)
