"""Double-single (f32x2) compensated arithmetic for the outer CG (NumberType df32).

Mirror of the JAX package's solvers/twofloat.py: each outer vector is an
unevaluated pair (hi, lo) of float32 tensors with |lo| <= ulp(hi)/2, and the
x/r/p updates run error-free transformations (Knuth two_sum, Dekker
two_prod), so the Krylov recursion carries ~49 mantissa bits while the
operator and the V-cycle apply in plain float32: the boundary NumberType
mixed draws with float64 vectors (api.MixedPrecisionOperator).  Dots are
compensated products reduced in float32.

The error-free steps are exact only when every product and every sum rounds
on its own.  Each eager torch op is its own kernel, so plain eager code keeps
them exact; do not ``torch.compile`` these functions, fuse them into a Triton
or CUDA kernel, or use fused ops such as ``addcmul``: all of those may
contract ``a * b - c`` into one FMA.

The JAX module's host-loop and chained variants work around the remote TPU
backend; the port has no such backend and leaves them out.  Its CG is a
Python loop with one host sync per iteration, like solvers/cg.py.

References: Dekker 1971 (error-free splitting), Ogita/Rump/Oishi 2005
(compensated dot), and the mixed-precision CG boundary of
multigrid_throughput.cc:1140-1268 (double outer vectors, float levels).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.phases import CG_ITERATION, CG_SOLVE, span
from .cg import CGResult

# Dekker splitting constant for f32: 2^12 + 1 (splits a 24-bit mantissa into
# two 12-bit halves so the half-products are exact in f32)
_SPLIT = 4097.0


class TF(NamedTuple):
    """A double-single value: hi + lo with |lo| <= ulp(hi)/2 (normalized)."""

    hi: torch.Tensor
    lo: torch.Tensor


def two_sum(a, b):
    """Error-free sum: s = fl(a+b), e exact error (Knuth, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free product via Dekker splitting: p = fl(a*b), e exact error."""
    p = a * b
    ah_t = _SPLIT * a
    ah = ah_t - (ah_t - a)
    al = a - ah
    bh_t = _SPLIT * b
    bh = bh_t - (bh_t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def tf_zeros_like(x: torch.Tensor) -> TF:
    z = torch.zeros_like(x, dtype=torch.float32)
    return TF(z, z)


def tf_from_f32(x: torch.Tensor) -> TF:
    x = x.to(torch.float32)
    return TF(x, torch.zeros_like(x))


def tf_split_f64_host(x) -> TF:
    """Split a float64 array or tensor into a double-single pair, at set-up
    time only (the solve never touches float64).  A tensor is split on its
    own device; a NumPy array gives CPU tensors."""
    x = torch.as_tensor(x).to(torch.float64)
    hi = x.to(torch.float32)
    lo = (x - hi.to(torch.float64)).to(torch.float32)
    return TF(hi, lo)


def tf_round(x: TF) -> torch.Tensor:
    """Round the pair to the nearest f32 (hi absorbs lo under normalization,
    but add anyway so un-normalized pairs round correctly)."""
    return x.hi + x.lo


def tf_to_f64(x: TF) -> torch.Tensor:
    """Exact float64 view (tests and error studies)."""
    return x.hi.to(torch.float64) + x.lo.to(torch.float64)


def _f32(alpha, like: torch.Tensor) -> torch.Tensor:
    # a 0-d f32 tensor, never a Python float: the scalar's own split and
    # products must round in f32 like the vector's
    return torch.as_tensor(alpha, dtype=torch.float32, device=like.device)


def tf_add(x: TF, y: TF) -> TF:
    """Double-single addition (sloppy dd-add: ~2^-47 relative)."""
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = fast_two_sum(s, e)
    return TF(hi, lo)


def tf_axpy(alpha, p: TF, x: TF) -> TF:
    """x + alpha * p with alpha an f32 scalar: two_prod keeps the product
    error, then a dd-add folds it into x."""
    alpha = _f32(alpha, p.hi)
    ph, pe = two_prod(alpha, p.hi)
    pe = pe + alpha * p.lo
    s, e = two_sum(x.hi, ph)
    e = e + (x.lo + pe)
    hi, lo = fast_two_sum(s, e)
    return TF(hi, lo)


def tf_axpy_f32(alpha, v: torch.Tensor, x: TF) -> TF:
    """x + alpha * v with v a plain f32 tensor (operator output)."""
    alpha = _f32(alpha, v)
    ph, pe = two_prod(alpha, v)
    s, e = two_sum(x.hi, ph)
    e = e + (x.lo + pe)
    hi, lo = fast_two_sum(s, e)
    return TF(hi, lo)


def tf_xpby(z: torch.Tensor, beta, p: TF) -> TF:
    """z + beta * p with z plain f32 (preconditioner output): the CG
    direction update."""
    beta = _f32(beta, z)
    ph, pe = two_prod(beta, p.hi)
    pe = pe + beta * p.lo
    s, e = two_sum(z, ph)
    e = e + pe
    hi, lo = fast_two_sum(s, e)
    return TF(hi, lo)


def _csum(h: torch.Tensor, c: torch.Tensor, allsum=None) -> torch.Tensor:
    """Reduce a compensated product stream: sum the exact high parts and the
    collected error terms separately (both f32 reductions), then combine.
    ``allsum`` adds each part over the ranks of a sharded vector first."""
    if allsum is not None:
        hc = allsum(torch.stack([torch.sum(h), torch.sum(c)]))
        return hc[0] + hc[1]
    return torch.sum(h) + torch.sum(c)


def tf_dot(a: TF, b: TF, weight: torch.Tensor | None = None, allsum=None) -> torch.Tensor:
    """Compensated dot of two double-single vectors -> f32 scalar tensor.

    The hi products are error-free (two_prod); the error terms and the
    hi*lo cross terms are collected in f32.  ``weight`` multiplies
    elementwise (the ownership mask of the hybrid layout)."""
    h, e = two_prod(a.hi, b.hi)
    c = e + (a.hi * b.lo + a.lo * b.hi)
    if weight is not None:
        w = weight.to(torch.float32)
        h = h * w
        c = c * w
    return _csum(h, c, allsum)


def tf_dot_f32(a: TF, v: torch.Tensor, weight: torch.Tensor | None = None,
               allsum=None) -> torch.Tensor:
    """Compensated dot of a double-single vector with a plain f32 vector."""
    h, e = two_prod(a.hi, v)
    c = e + a.lo * v
    if weight is not None:
        w = weight.to(torch.float32)
        h = h * w
        c = c * w
    return _csum(h, c, allsum)


def tf_norm(a: TF, weight: torch.Tensor | None = None, allsum=None) -> torch.Tensor:
    return torch.sqrt(tf_dot(a, a, weight, allsum))


def cg_solve_df32(
    a_vmult: Callable,
    b: TF,
    preconditioner: Callable | None = None,
    maxiter: int = 10000,
    abstol: float = 1e-20,
    reltol: float = 1e-4,
    force_iterations: int | None = None,
    weight: torch.Tensor | None = None,
    allsum=None,
) -> CGResult:
    """PCG with double-single outer vectors, deal.II ordering (as
    cg.cg_solve: the preconditioner applies after the convergence test, beta
    is 0 on the first iteration).

    ``a_vmult`` and ``preconditioner`` are plain f32 maps (the hybrid
    operator and the f32 V-cycle); x, r, p carry (hi, lo) pairs.  Returns a
    CGResult whose x is the TF pair (callers round or widen it).  On a
    sharded level ``allsum`` adds every dot's partials over the ranks.  The
    profiler ranges are cg_solve's."""
    if preconditioner is None:
        preconditioner = lambda r: r
    with span(CG_SOLVE):
        x = tf_zeros_like(b.hi)
        r = TF(b.hi, b.lo)
        p = x
        rz = tf_dot(r, r, weight, allsum)
        norm0 = float(torch.sqrt(rz))
        if force_iterations is not None:
            tol, maxiter = 0.0, force_iterations
        else:
            tol = max(abstol, reltol * norm0)
        res = norm0
        it = 0
        while res > tol and it < maxiter:
            with span(CG_ITERATION):
                z = preconditioner(tf_round(r))
                rz_new = tf_dot_f32(r, z, weight, allsum)
                p = tf_xpby(z, rz_new / rz, p) if it > 0 else tf_from_f32(z)
                ap = a_vmult(tf_round(p))
                alpha = rz_new / tf_dot_f32(p, ap, weight, allsum)
                x = tf_axpy(alpha, p, x)
                r = tf_axpy_f32(-alpha, ap, r)
                rz = rz_new
                it += 1
                res = float(tf_norm(r, weight, allsum))
    return CGResult(x, it, res, res <= tol, norm0)
