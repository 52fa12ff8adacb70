"""Smoothed-aggregation algebraic multigrid.

Capability mirror of the reference's Trilinos-ML / BoomerAMG usage
(multigrid_throughput.cc:975-1073): an algebraic preconditioner for the
assembled sparse system, used standalone ("AMG"/"AMGPETSc" solver types) or
as the multigrid coarse solver with n_cycles applications.

Set-up runs on the host with SciPy (strength-of-connection filtering, greedy
aggregation, Jacobi-smoothed tentative prolongators, Galerkin triple
products) and is the JAX package's, statement for statement, so that both
build the same hierarchy.  The apply is a V-cycle over padded ELL sparse
matrices on one torch device: a gather and a row sum per product,
damped-Jacobi smoothing, and a dense Cholesky pair on the coarsest level.
Restriction applies the transposed prolongator as an ELL table of its own,
built at set-up: a gather again, so that a float32 restriction sums in one
order on every run (a scatter-add on CUDA sums with atomics in no fixed
order, and an outer iteration count near its tolerance could change between
two solves of one run).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.device import resolve_device
from ..utils.phases import AMG_PHASES, AMG_SHAPE, KEYS, SETUP, untimed


@dataclass(frozen=True)
class ELLMatrix:
    """Padded sparse rows: y[i] = sum_k vals[i, k] * x[idx[i, k]].

    Padding entries carry index 0 and value 0.  ``t`` is the transposed
    matrix in the same format, where the matrix was built with one."""

    idx: torch.Tensor    # int32 [n, K]
    vals: torch.Tensor   # float [n, K]
    shape: tuple
    t: "ELLMatrix | None" = None

    @property
    def K(self) -> int:
        return self.idx.shape[1]

    @property
    def nbytes(self) -> int:
        own = self.idx.numel() * self.idx.element_size() + self.vals.numel() * self.vals.element_size()
        return own + (self.t.nbytes if self.t is not None else 0)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return (self.vals * x[self.idx]).sum(dim=1)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A^T y through the transposed table."""
        if self.t is None:
            raise ValueError("this ELLMatrix was built without its transpose")
        return self.t.matvec(y)


def _ell_tables(A: sp.csr_matrix) -> tuple[np.ndarray, np.ndarray]:
    """(idx int32 [n, K], vals float64 [n, K]) of a CSR matrix, K its widest
    row (at least 1)."""
    A = A.tocsr()
    counts = np.diff(A.indptr)
    K = max(int(counts.max()), 1)
    n = A.shape[0]
    idx = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K))
    for k in range(K):
        has = counts > k
        pos = A.indptr[:-1][has] + k
        idx[has, k] = A.indices[pos]
        vals[has, k] = A.data[pos]
    return idx, vals


def _to_ell(A: sp.csr_matrix, dtype: torch.dtype, with_transpose: bool = False,
            device: torch.device | None = None) -> ELLMatrix:
    """The ELL tables of ``A`` as tensors on ``device`` (None: the host;
    build_amg moves them itself)."""
    idx, vals = _ell_tables(A)
    t = _to_ell(A.T.tocsr(), dtype, device=device) if with_transpose else None
    return ELLMatrix(
        torch.as_tensor(idx, device=device), torch.as_tensor(vals, dtype=dtype, device=device),
        A.shape, t,
    )


def _greedy_aggregate(S: sp.csr_matrix) -> np.ndarray:
    """Two-phase aggregation on the strength graph, fully vectorised.

    Phase 1 runs min-index independent-set rounds: a free node roots an
    aggregate when its index is smallest among its still-free neighbours and
    no neighbour is aggregated yet; the root absorbs its whole unaggregated
    neighbourhood.  Converges in a handful of rounds, each a few NumPy
    passes over nnz.  Phase 2 attaches leftovers to a neighbouring aggregate
    or makes singletons."""
    n = S.shape[0]
    indptr, indices = S.indptr.astype(np.int64), S.indices.astype(np.int64)
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    off_diag = indices != rows
    agg = np.full(n, -1, np.int64)
    next_agg = 0

    def row_reduce(op, vals, empty):
        out = np.full(n, empty, dtype=vals.dtype if vals.size else np.int64)
        has = counts > 0
        if vals.size:
            red = op.reduceat(vals, indptr[:-1][has])
            out[has] = red
        return out

    for _ in range(64):
        free = agg < 0
        if not free.any():
            break
        # nodes whose neighbourhood holds no aggregated node
        nb_aggregated = (~free[indices]).astype(np.int64)
        any_agg = row_reduce(np.maximum, nb_aggregated, 0) > 0
        eligible = free & ~any_agg
        if not eligible.any():
            break
        # min index among eligible OFF-DIAGONAL neighbours
        cand = np.where(
            eligible[indices] & off_diag, indices, np.int64(n)
        )
        min_nb = row_reduce(np.minimum, cand, np.int64(n))
        roots = eligible & (np.arange(n) < min_nb)
        if not roots.any():
            break
        ids = np.full(n, -1, np.int64)
        nr = int(roots.sum())
        ids[roots] = next_agg + np.arange(nr)
        next_agg += nr
        agg[roots] = ids[roots]
        # absorb unaggregated neighbours (roots are independent, so a node
        # adjacent to two roots takes an arbitrary one — both are valid)
        sel = roots[rows] & free[indices]
        agg[indices[sel]] = ids[rows[sel]]

    # phase 2: attach leftovers to any neighbouring aggregate
    left = agg < 0
    if left.any():
        nbagg = np.where(agg[indices] >= 0, agg[indices], np.int64(-1))
        best = row_reduce(np.maximum, nbagg, np.int64(-1))
        take = left & (best >= 0)
        agg[take] = best[take]
        # isolated leftovers become singletons
        iso = agg < 0
        niso = int(iso.sum())
        if niso:
            agg[iso] = next_agg + np.arange(niso)
            next_agg += niso
    return agg


@dataclass(frozen=True)
class AMGLevel:
    A: ELLMatrix
    P: ELLMatrix | None       # prolongation to this (finer) level from coarser
    inv_diag: torch.Tensor
    omega: float


@dataclass(frozen=True)
class AMGPreconditioner:
    """V-cycle smoothed-aggregation AMG (finest level first).

    Every step of an application runs through ``hook`` (as
    ``Multigrid.hook``: ``hook(phase, level, fn, *args)``, level 0 the
    finest here), in three phases that split it: ``amg_smooth`` (the
    Jacobi sweeps with their products), ``amg_transfer`` (the residual,
    the restriction by P^T, the prolongation by P and the correction, and
    between cycles the finest level's residual and correction) and
    ``amg_dense`` (the coarsest level's triangular pair)."""

    levels: tuple
    chol: torch.Tensor        # dense Cholesky factor of the coarsest matrix
    n_cycles: int = 1
    n_smooth: int = 2
    hook: Callable = field(default=untimed, compare=False)

    def _smooth(self, lev: AMGLevel, x: torch.Tensor | None, b: torch.Tensor) -> torch.Tensor:
        """``n_smooth`` damped-Jacobi sweeps from ``x`` (None: zero)."""
        if x is None:
            x = torch.zeros_like(b)
        for _ in range(self.n_smooth):
            x = x + lev.omega * lev.inv_diag * (b - lev.A.matvec(x))
        return x

    @staticmethod
    def _residual(A: ELLMatrix, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return b - A.matvec(x)

    @staticmethod
    def _restrict(A: ELLMatrix, P: ELLMatrix, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return P.rmatvec(b - A.matvec(x))

    @staticmethod
    def _correct(P: ELLMatrix, x: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
        return x + P.matvec(xc)

    def _dense(self, b: torch.Tensor) -> torch.Tensor:
        y = torch.linalg.solve_triangular(
            self.chol, b.to(self.chol.dtype).unsqueeze(1), upper=False
        )
        x = torch.linalg.solve_triangular(self.chol.T, y, upper=True)
        return x.squeeze(1).to(b.dtype)

    def _v(self, k: int, b: torch.Tensor) -> torch.Tensor:
        ph, lev = self.hook, self.levels[k]
        if k == len(self.levels) - 1:
            return ph("amg_dense", k, self._dense, b)
        x = ph("amg_smooth", k, self._smooth, lev, None, b)
        Pc = self.levels[k + 1].P
        xc = self._v(k + 1, ph("amg_transfer", k, self._restrict, lev.A, Pc, b, x))
        x = ph("amg_transfer", k, self._correct, Pc, x, xc)
        return ph("amg_smooth", k, self._smooth, lev, x, b)

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        ph, A = self.hook, self.levels[0].A
        x = self._v(0, b)
        for _ in range(self.n_cycles - 1):
            dx = self._v(0, ph("amg_transfer", 0, self._residual, A, b, x))
            x = ph("amg_transfer", 0, torch.add, x, dx)
        return x

    __call__ = vmult

    def graph_reason(self) -> str | None:
        return None if self.hook is untimed else "hook"

    def with_hook(self, hook: Callable, phases: tuple = KEYS) -> "AMGPreconditioner":
        return self if set(AMG_PHASES).isdisjoint(phases) else dataclasses.replace(self, hook=hook)

    def describe(self) -> list[dict]:
        """Per level, finest first: rows, the widest row of A, of P and of
        P^T (K), and the bytes of the level's device tables."""
        out = []
        for lev in self.levels:
            P = lev.P
            nbytes = lev.A.nbytes + lev.inv_diag.numel() * lev.inv_diag.element_size()
            out.append({
                "rows": lev.A.shape[0],
                "K_A": lev.A.K,
                "K_P": P.K if P is not None else 0,
                "K_PT": P.t.K if P is not None else 0,
                "bytes": nbytes + (P.nbytes if P is not None else 0),
                "omega": lev.omega,
            })
        return out


def factor_dtype(level_dtype: torch.dtype) -> torch.dtype:
    """The dtype of a dense Cholesky factor (the direct coarse solve's, the
    AMG's coarsest) under levels of ``level_dtype``: float32 under
    bfloat16, whose triangular solves torch does not take; the level dtype
    otherwise."""
    return torch.float32 if level_dtype == torch.bfloat16 else level_dtype


def _lam_max_dinv_a(A: sp.csr_matrix, d: np.ndarray, iters: int = 12) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) (host, SciPy).

    D^-1 A is similar to the SPD D^-1/2 A D^-1/2, so the power method
    converges to the true spectral radius; 12 iterations + 5% headroom
    bounds it well enough for a smoother-weight clamp (an underestimate
    only re-approaches the nominal omega, never over-relaxes past it by
    more than the headroom)."""
    n = A.shape[0]
    dinv = 1.0 / np.where(d == 0, 1.0, d)
    rng = np.random.default_rng(12)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = dinv * (A @ v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0 or not np.isfinite(lam):
            return 2.0
        v = w / lam
    return 1.05 * lam


def _host_hierarchy(
    A: sp.csr_matrix, theta: float, omega: float, coarse_size: int, max_levels: int,
    aggressive_levels: int, strength: str,
) -> tuple[list, sp.csr_matrix]:
    """The host levels (A, P or None, 1/diag, omega), finest first, and the
    coarsest matrix (SciPy)."""
    host_levels = []          # (A, P or None, 1/diag, omega), finest first
    A = A.tocsr()
    P_for_level = None
    while True:
        d = A.diagonal()
        # Weighted Jacobi diverges when omega >= 2/lambda_max(D^-1 A); on
        # aggressive/classical hierarchies the Galerkin coarse operators can
        # push lambda_max past 2.2, where the boomer-analog's omega=0.9
        # amplifies every sweep.  Clamp per level to the hypre-style
        # spectral rule; the clamp is inactive where the nominal omega is
        # already safe (ML-analog 2/3 at lambda <= 2.7).
        lam = _lam_max_dinv_a(A, d)
        host_levels.append(
            (A, P_for_level, 1.0 / np.where(d == 0, 1.0, d), min(omega, 1.8 / lam))
        )
        if A.shape[0] <= coarse_size or len(host_levels) >= max_levels:
            break
        # strength-of-connection filter
        absA = abs(A)
        if strength == "classical":
            # HYPRE/BoomerAMG row-relative rule: j strong for i when
            # |a_ij| >= theta * max_{k != i} |a_ik|  (an absolute threshold
            # on the diagonally-scaled matrix would disconnect everything
            # at theta ~ 0.5)
            off = absA - sp.diags(absA.diagonal())
            rowmax = np.asarray(off.max(axis=1).todense()).ravel()
            S = absA.tocsr().copy()
            thr = theta * rowmax
            mask = S.data < thr.repeat(np.diff(S.indptr))
            S.data[mask] = 0.0
            S.eliminate_zeros()
        else:
            scale = 1.0 / np.sqrt(np.maximum(d, 1e-300))
            S = sp.diags(scale) @ absA @ sp.diags(scale)
            S.data[S.data < theta] = 0.0
            S.eliminate_zeros()
        agg = _greedy_aggregate(S)
        if len(host_levels) <= aggressive_levels:
            # second aggregation pass on the aggregate strength graph
            n1 = int(agg.max()) + 1
            Q = sp.csr_matrix(
                (np.ones(S.shape[0]), (np.arange(S.shape[0]), agg)),
                shape=(S.shape[0], n1),
            )
            S2 = (Q.T @ S @ Q).tocsr()
            agg = _greedy_aggregate(S2)[agg]
        n_agg = int(agg.max()) + 1
        if n_agg >= A.shape[0]:
            break
        P0 = sp.csr_matrix(
            (np.ones(A.shape[0]), (np.arange(A.shape[0]), agg)),
            shape=(A.shape[0], n_agg),
        )
        # Jacobi-smoothed prolongator
        Dinv = sp.diags(1.0 / np.where(d == 0, 1.0, d))
        P = (P0 - omega * (Dinv @ (A @ P0))).tocsr()
        A = (P.T @ A @ P).tocsr()
        P_for_level = P
    return host_levels, A


def build_amg(
    A: sp.csr_matrix,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
    theta: float = 0.02,
    omega: float = 2.0 / 3.0,
    coarse_size: int = 800,
    max_levels: int = 12,
    n_cycles: int = 1,
    aggressive_levels: int = 0,
    n_smooth: int = 2,
    strength: str = "scaled",
) -> AMGPreconditioner:
    """The hierarchy of ``A`` on ``device`` (None: the card; a CPU build
    passes ``"cpu"``).  ``aggressive_levels``: on the first k coarsening
    steps, aggregate the aggregate graph a second time (HYPRE's aggressive
    coarsening analog — coarsens ~2x faster per level at the cost of extra
    iterations)."""
    device = resolve_device(device)
    with SETUP.span("mgtpu.setup.amg_build"):
        host_levels, A = _host_hierarchy(
            A, theta, omega, coarse_size, max_levels, aggressive_levels, strength
        )
        # the coarsest matrix, dense, with the JAX package's diagonal shift;
        # its lower triangle's nonzeros, diagonal included, for AMG_SHAPE
        lower = sp.tril(A, -1, format="csr")
        dense_nnz = int(lower.count_nonzero()) + A.shape[0]
        Ad = A.toarray()
        Ad.flat[:: Ad.shape[0] + 1] += 1e-12 * max(Ad.diagonal().max(), 1.0)
        # the ELL tables on the host, then everything to the device
        host_ell = [
            (_to_ell(Al, dtype), None if Pl is None else _to_ell(Pl, dtype, with_transpose=True))
            for Al, Pl, _, _ in host_levels
        ]

    def put(m: ELLMatrix | None) -> ELLMatrix | None:
        if m is None:
            return None
        return ELLMatrix(m.idx.to(device), m.vals.to(device), m.shape, put(m.t))

    with SETUP.span("mgtpu.setup.amg_upload"):
        levels = tuple(
            AMGLevel(put(Ae), put(Pe), torch.as_tensor(dinv, dtype=dtype, device=device), om)
            for (Ae, Pe), (_, _, dinv, om) in zip(host_ell, host_levels)
        )
        Ad_d = torch.as_tensor(Ad, device=device)
    # dense Cholesky on the device, in float64, kept in factor_dtype.
    # Rows that see the identity (Dirichlet and hanging DoFs) are singleton
    # aggregates on every level, so the coarsest matrix never falls below
    # their count (25,802 of the 283,109 rows of quadrant r=7 at p=1): too
    # large to factor on the host in reasonable time.
    with SETUP.span("mgtpu.setup.amg_factor"):
        chol64 = torch.linalg.cholesky(Ad_d)
        del Ad_d
        chol = chol64.to(factor_dtype(dtype))
        del chol64
    amg = AMGPreconditioner(levels, chol, n_cycles=n_cycles, n_smooth=n_smooth)
    AMG_SHAPE.clear()
    AMG_SHAPE.update({
        "levels": [
            {"rows": Al.shape[0], "nnz_A": int(Al.nnz), "nnz_P": 0 if Pl is None else int(Pl.nnz),
             **{k: d[k] for k in ("K_A", "K_P", "K_PT", "bytes", "omega")}}
            for (Al, Pl, _, _), d in zip(host_levels, amg.describe())
        ],
        "value_dtype": str(dtype).replace("torch.", ""),
        "dense_rows": chol.shape[0],
        "dense_nnz": dense_nnz,
        "factor_dtype": str(chol.dtype).replace("torch.", ""),
        "n_cycles": n_cycles,
        "n_smooth": n_smooth,
    })
    return amg


def build_amg_boomer(
    A: sp.csr_matrix, dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None, n_cycles: int = 1, **kw,
) -> AMGPreconditioner:
    """The second, distinctly-parameterized algebraic flavour ("AMGPETSc"):
    mirrors the reference's BoomerAMG configuration (strong threshold 0.5,
    aggressive coarsening on 2 levels, symmetric-sweep smoothing —
    multigrid_throughput.cc:1022-1068) in smoothed-aggregation terms.  The
    hierarchy is coarser and cheaper per cycle than the default ML-analog
    (theta 0.02), trading iterations for level count — reproducing the
    two-backend comparison of parameters_hp_amg.py."""
    return build_amg(
        A,
        dtype=dtype,
        device=device,
        theta=0.5,
        omega=0.9,
        aggressive_levels=2,
        n_smooth=2,
        n_cycles=n_cycles,
        strength="classical",
        **kw,
    )
