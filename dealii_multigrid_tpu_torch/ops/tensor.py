"""1D finite-element tables for tensor-product Q_p elements on [0, 1].

These are the host-side (NumPy, float64) building blocks from which all device
kernels derive: Gauss-Lobatto support points (the nodal basis of Q_p, as in
deal.II's FE_Q), Gauss quadrature, Lagrange basis evaluation via stable
barycentric formulas, 1D mass/stiffness matrices, and the h-/p-embedding
matrices used by multigrid transfers.

Reference parity: the reference evaluates Q_p with FE_Q (Gauss-Lobatto support
points) under QGauss(p+1) quadrature (reference: include/operator.h:37-42,
multigrid_throughput.cc:2262-2279).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "gauss_points",
    "gauss_lobatto_points",
    "lagrange_values",
    "lagrange_derivatives",
    "shape_tables",
    "mass_matrix_1d",
    "stiffness_matrix_1d",
    "h_embedding_1d",
    "p_embedding_1d",
]


@functools.lru_cache(maxsize=None)
def gauss_points(n_points: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n_points)
    return 0.5 * (x + 1.0), 0.5 * w


@functools.lru_cache(maxsize=None)
def gauss_lobatto_points(n_points: int) -> np.ndarray:
    """Gauss-Lobatto points on [0, 1] (the Q_p support points), ascending.

    For n_points == 2 these are just the endpoints (Q_1).  Interior points are
    the roots of P'_{n-1}, the derivative of the Legendre polynomial.
    """
    if n_points < 2:
        raise ValueError("need at least 2 points (degree >= 1)")
    if n_points == 2:
        return np.array([0.0, 1.0])
    # Interior points: roots of d/dx P_{n-1}(x) on (-1, 1).
    deriv = np.polynomial.legendre.Legendre.basis(n_points - 1).deriv()
    interior = np.sort(deriv.roots().real)
    full = np.concatenate([[-1.0], interior, [1.0]])
    return 0.5 * (full + 1.0)


def _barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def lagrange_values(nodes: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """V[q, i] = l_i(pts[q]) for the Lagrange basis on ``nodes`` (barycentric)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    w = _barycentric_weights(nodes)
    out = np.empty((len(pts), len(nodes)))
    for q, x in enumerate(pts):
        d = x - nodes
        exact = np.abs(d) < 1e-14
        if exact.any():
            row = exact.astype(np.float64)
        else:
            t = w / d
            row = t / t.sum()
        out[q] = row
    return out


def lagrange_derivatives(nodes: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """D[q, i] = l_i'(pts[q]).

    Computed from the differentiation matrix on the nodes composed with basis
    interpolation: l_i'(x) = sum_j l_i'(node_j) * m_j(x) does NOT hold for
    Lagrange of the same degree... instead we use the exact product-rule form.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    n = len(nodes)
    out = np.zeros((len(pts), n))
    for q, x in enumerate(pts):
        for i in range(n):
            s = 0.0
            for j in range(n):
                if j == i:
                    continue
                prod = 1.0 / (nodes[i] - nodes[j])
                for k in range(n):
                    if k == i or k == j:
                        continue
                    prod *= (x - nodes[k]) / (nodes[i] - nodes[k])
                s += prod
            out[q, i] = s
    return out


@functools.lru_cache(maxsize=None)
def shape_tables(degree: int, n_q: int | None = None):
    """(B, D, q_pts, q_wts): values/derivatives of the Q_degree nodal basis at
    the Gauss quadrature points on [0, 1].  B[q, i] = l_i(x_q)."""
    if n_q is None:
        n_q = degree + 1
    nodes = gauss_lobatto_points(degree + 1)
    q, w = gauss_points(n_q)
    return lagrange_values(nodes, q), lagrange_derivatives(nodes, q), q, w


@functools.lru_cache(maxsize=None)
def mass_matrix_1d(degree: int) -> np.ndarray:
    """Exact 1D mass matrix on [0,1] for the Q_degree GL nodal basis."""
    n_q = degree + 1  # Gauss(p+1) integrates degree 2p+1 >= 2p exactly
    B, _, _, w = shape_tables(degree, n_q)
    return np.einsum("q,qi,qj->ij", w, B, B)


@functools.lru_cache(maxsize=None)
def stiffness_matrix_1d(degree: int) -> np.ndarray:
    """Exact 1D stiffness matrix on [0,1] for the Q_degree GL nodal basis."""
    n_q = degree + 1
    _, D, _, w = shape_tables(degree, n_q)
    return np.einsum("q,qi,qj->ij", w, D, D)


@functools.lru_cache(maxsize=None)
def h_embedding_1d(degree: int) -> np.ndarray:
    """E[c] (c in {0,1}): parent Q_degree basis evaluated at child-c node
    positions; u_child = E[c] @ u_parent reproduces the parent polynomial.

    Child c covers [c/2, (c+1)/2] of the parent; child node x maps to parent
    coordinate (x + c) / 2.
    """
    nodes = gauss_lobatto_points(degree + 1)
    out = np.stack(
        [lagrange_values(nodes, 0.5 * (nodes + c)) for c in (0.0, 1.0)]
    )
    return out


@functools.lru_cache(maxsize=None)
def p_embedding_1d(degree_coarse: int, degree_fine: int) -> np.ndarray:
    """E: coarse Q_qc basis evaluated at fine Q_qf node positions (same cell);
    u_fine = E @ u_coarse.  Used by polynomial-coarsening transfers
    (reference: MGTwoLevelTransfer p-variant, multigrid_throughput.cc:1506-1510).
    """
    coarse_nodes = gauss_lobatto_points(degree_coarse + 1)
    fine_nodes = gauss_lobatto_points(degree_fine + 1)
    return lagrange_values(coarse_nodes, fine_nodes)
