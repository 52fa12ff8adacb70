"""Chebyshev-Jacobi smoother with CG-Lanczos eigenvalue estimation.

Mirror of deal.II's PreconditionChebyshev + DiagonalMatrix as the reference
uses them (multigrid_throughput.cc:849-883, 936-960): ``eig_cg_n_iterations``
Jacobi-preconditioned CG steps estimate the largest eigenvalue of D^{-1} A
(Lanczos tridiagonal from the CG coefficients, eigvalsh on the host), the
caller applies the 1.2 safety factor, and the smoother works on
[max_eig / smoothing_range, max_eig].  ``degree`` follows deal.II (degree 1
is damped Jacobi).

A step of the smoother is one operator application and the vector work of
the recurrence.  Where the operator offers its result before the identity
blend on constrained slots (``vmult_split``, the hybrid engine's levels)
and the vectors are float32 or float64 CUDA tensors, that vector work runs
as one kernel (ops/chebyshev_step.py), bit for bit the eager chain; every
other case (CPU tensors, bfloat16 levels, the gather engine's and the
Stokes operators) runs the eager chain (``takes_kernel``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import chebyshev_step as cs
from ..utils import threefry
from ..utils.phases import setup_span

# the JAX package draws every start vector from jax.random.PRNGKey(42)
START_SEED = 42


def takes_kernel(op, v) -> bool:
    """Whether the steps of a smoother on ``op`` with vectors like ``v`` run
    as one kernel each: ``op`` offers ``vmult_split`` and ``v`` is a float32
    or float64 CUDA tensor."""
    return hasattr(op, "vmult_split") and v.device.type == "cuda" and v.dtype in cs.DTYPES


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
    op, inv_diag: torch.Tensor, b0: torch.Tensor | None = None,
    n_iterations: int = 20, use_op_dot: bool = False,
) -> tuple[float, float]:
    """Largest/smallest eigenvalue estimate of D^{-1} A via CG-Lanczos on
    the start vector ``b0``; one host transfer of the coefficients.  With
    ``b0`` None the start vector is the JAX package's:
    ``jax.random.normal(PRNGKey(42), (n,), inv_diag.dtype)``
    (``utils.threefry``).

    A step whose residual product r.z falls below the smallest normal
    number ends the tridiagonal: CG has converged exactly there.  The JAX
    package's backends flush such a subnormal to zero and the next step
    breaks down; torch keeps subnormals (on the CPU and on CUDA), and the
    steps after them are rounding noise that can put lambda_max far above
    the spectrum (a 216-slot float32 level gave 37 instead of 1.21)."""
    dot = op.dot if use_op_dot else (lambda a, c: torch.sum(a * c))
    if b0 is None:
        b0 = threefry.normal(START_SEED, inv_diag.shape[0], inv_diag.dtype, inv_diag.device)
    r = b0.to(inv_diag.dtype)
    p = inv_diag * r
    rz = dot(r, p)
    alphas, betas, rzs = [], [], []
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
        rzs.append(rz_new)
    # widened exactly on the host: NumPy has no bfloat16
    coeffs = torch.stack([torch.stack(v) for v in (alphas, betas, rzs)])
    coeffs = coeffs.to(device="cpu", dtype=torch.float64).numpy()
    sub = np.nonzero(np.abs(coeffs[2]) < torch.finfo(inv_diag.dtype).tiny)[0]
    k = int(sub[0]) + 1 if len(sub) else n_iterations
    return _extremes_from_cg_coefficients(coeffs[0, :k], coeffs[1, :k])


@setup_span("mgtpu.setup.eigenvalues")
def estimate_eigenvalue_ranges(
    ops, inv_diags, b0s=None, n_iterations: int = 20, use_op_dot: bool = False,
) -> list[tuple[float, float]]:
    """Per-level estimates for a hierarchy; every level is estimated.  A
    None entry of ``b0s`` (or ``b0s`` None) takes the JAX package's start
    vector, ``jax.random.normal(PRNGKey(42), (n,), dtype)``: one draw at
    the largest n of each dtype, of which every level takes its first n
    entries, as a draw of n entries is the prefix of any longer one."""
    b0s = list(b0s) if b0s is not None else [None] * len(inv_diags)
    longest: dict = {}
    for d, b in zip(inv_diags, b0s):
        if b is None:
            key = (d.dtype, d.device)
            longest[key] = max(longest.get(key, 0), d.shape[0])
    draws = {k: threefry.normal(START_SEED, n, *k) for k, n in longest.items()}
    return [
        estimate_eigenvalue_range(
            op, d, draws[(d.dtype, d.device)][: d.shape[0]] if b is None else b,
            n_iterations, use_op_dot,
        )
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

    def _step(self, x, b, d=None, c_d=None, c_r=None, theta=None):
        """(x', d') of one step from ``x``: of the three-term recurrence
        (``d``, ``c_d``, ``c_r``), or where ``d`` is None the first of a
        smoothing, d' = (D^{-1} r) / theta.  One kernel where
        ``takes_kernel`` holds, the eager chain otherwise."""
        if takes_kernel(self.op, b):
            ar, keep = self.op.vmult_split(x)
            if d is None:
                return cs.first_step(ar, keep, x, b, self.inv_diag, theta)
            return cs.recurrence_step(ar, keep, x, d, b, self.inv_diag, c_d, c_r)
        ax = self.op.vmult(x)
        if d is None:
            return cs.first_reference(ax, x, b, self.inv_diag, theta)
        return cs.recurrence_reference(ax, x, d, b, self.inv_diag, c_d, c_r)

    def _recurrence(self, x, d, b, sigma, delta, n_steps):
        rho_old = 1.0 / sigma
        for _ in range(n_steps):
            rho = 1.0 / (2.0 * sigma - rho_old)
            x, d = self._step(x, b, d, rho * rho_old, 2.0 * rho / delta)
            rho_old = rho
        return x

    def step(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Chebyshev iteration from initial guess x (three-term recurrence)."""
        theta, delta, sigma = self._scalars(b.dtype)
        x, d = self._step(x, b, theta=float(theta))
        return self._recurrence(x, d, b, sigma, delta, self.degree - 1)

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        """Apply as a preconditioner (zero initial guess); saves the first
        operator application since r0 = b."""
        theta, delta, sigma = self._scalars(b.dtype)
        d = (self.inv_diag * b) / float(theta)
        return self._recurrence(d, d, b, sigma, delta, self.degree - 1)
