"""Reference-cell element matrices and quadrature tables for Q_p on [0,1]^dim.

TPU-first design note: the reference evaluates cell integrals by SIMD
sum-factorization (reference: include/operator.h:450-493, FEEvaluation).  On
TPU, for the Cartesian axis-aligned cells produced by octree refinement, every
cell shares ONE reference element matrix up to a scalar (h^(dim-2) for the
Laplacian), so the whole matrix-free apply collapses to a single large GEMM
``[n_cells, n_loc] @ [n_loc, n_loc]`` riding the 128x128 MXU at full tilt —
far better MXU utilisation than the K=(p+1) contractions of sum-factorization.
A sum-factorized einsum path is kept for high p and as a cross-check.
"""

from __future__ import annotations

import functools

import numpy as np

from . import tensor


@functools.lru_cache(maxsize=None)
def laplace_element_matrix(dim: int, degree: int) -> np.ndarray:
    """Reference stiffness matrix on [0,1]^dim, x-fastest local ordering.

    Physical cell of edge h: A_cell = h^(dim-2) * A_ref.
    """
    K = tensor.stiffness_matrix_1d(degree)
    M = tensor.mass_matrix_1d(degree)
    mats = []
    for d in range(dim):
        term = np.array([[1.0]])
        # x-fastest flattening means axis 0 (x) is the *innermost* kron factor
        for e in range(dim):
            f = K if e == d else M
            term = np.kron(f, term)
        mats.append(term)
    return sum(mats)


@functools.lru_cache(maxsize=None)
def mass_element_matrix(dim: int, degree: int) -> np.ndarray:
    """Reference mass matrix on [0,1]^dim. Physical: M_cell = h^dim * M_ref."""
    M = tensor.mass_matrix_1d(degree)
    out = np.array([[1.0]])
    for _ in range(dim):
        out = np.kron(M, out)
    return out


@functools.lru_cache(maxsize=None)
def quadrature_tables(dim: int, degree: int, n_q_1d: int | None = None):
    """(B3, q_pts, q_wts): tensor-product shape values at Gauss points.

    B3[q, i] = phi_i(x_q) on [0,1]^dim (x-fastest for both q and i);
    q_pts [nq^dim, dim]; q_wts [nq^dim].
    """
    if n_q_1d is None:
        n_q_1d = degree + 1
    B, _, q, w = tensor.shape_tables(degree, n_q_1d)
    B3 = np.array([[1.0]])
    for _ in range(dim):
        B3 = np.kron(B, B3)
    nq = len(q)
    pts = np.empty((nq**dim, dim))
    wts = np.ones(nq**dim)
    flat = np.arange(nq**dim)
    for d in range(dim):
        idx = (flat // nq**d) % nq
        pts[:, d] = q[idx]
        wts *= w[idx]
    return B3, pts, wts


def sum_factorized_laplace_reference(u_cells: np.ndarray, dim: int, degree: int) -> np.ndarray:
    """NumPy sum-factorized Laplace apply on the reference cell (testing aid;
    mirrors the evaluate->scale->integrate structure of operator.h:461-472)."""
    n = degree + 1
    B, D, _, w = tensor.shape_tables(degree, n)
    nc = u_cells.shape[0]
    shape = (nc,) + (n,) * dim
    u = u_cells.reshape(shape)
    out = np.zeros_like(u)
    # tensor-product quadrature weights
    Wt = np.ones((1,) * dim)
    for d in range(dim):
        shp = [1] * dim
        shp[d] = n
        Wt = Wt * w.reshape(shp)
    for d in range(dim):
        g = u
        for e in range(dim):
            mat = D if e == d else B
            # contract axis e+1 (cell axis is 0); axes are (x=1, y=2, z=3)
            g = np.moveaxis(np.tensordot(g, mat, axes=([e + 1], [1])), -1, e + 1)
        g = g * Wt[None]
        for e in range(dim):
            mat = D if e == d else B
            g = np.moveaxis(np.tensordot(g, mat.T, axes=([e + 1], [1])), -1, e + 1)
        out += g
    return out.reshape(nc, -1)
