"""Plain reference of the benchmark's Poisson problem.

Continuous Q_p elements (Gauss-Lobatto nodes, as deal.II's FE_Q) on a 2:1
corner-balanced octree over [-1, 1]^3, homogeneous Dirichlet boundary (the
Gaussian load's boundary values enter through a lift), hanging-node
constraints by interpolation from the coarser neighbour, and QGauss(p+1)
load integrals: the discrete problem of the deal.II multigrid benchmark
(arXiv:2203.12292) for the "Constant" and "Gaussian" simulation types.

This module stands apart from the program under test: it builds the mesh
from its description, numbers the nodes by their exact positions, derives
the constraints and the element tables itself, and never assembles a
matrix: the operator is applied cell by cell.  The host work is NumPy and
SciPy; the cell loop runs as plain torch operations in float64 on the
device it is given.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

DIM = 3
#: the Gaussian load: centre and width of the reference's manufactured
#: solution exp(-|x - c|^2 / w^2) / (sqrt(2 pi) w)^dim
GAUSS_CENTER, GAUSS_WIDTH = -0.5, 0.1
_BLOCK = 1 << 16  # cells per block of the cell loop


# ----------------------------------------------------------------- 1D tables


def gll_nodes(p: int) -> np.ndarray:
    """Gauss-Lobatto points of degree p on [0, 1], ascending."""
    if p == 1:
        return np.array([0.0, 1.0])
    c = np.zeros(p + 1)
    c[p] = 1.0
    inner = np.sort(np.polynomial.legendre.legroots(np.polynomial.legendre.legder(c)).real)
    return 0.5 * (np.concatenate([[-1.0], inner, [1.0]]) + 1.0)


def lagrange(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values and derivatives [len(x), len(nodes)] of the Lagrange basis."""
    n = len(nodes)
    x = np.asarray(x, np.float64)
    val = np.ones((len(x), n))
    der = np.zeros((len(x), n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        denom = np.prod([nodes[i] - nodes[j] for j in others])
        for j in others:
            val[:, i] *= x - nodes[j]
        for k in others:
            term = np.ones(len(x))
            for j in others:
                if j != k:
                    term *= x - nodes[j]
            der[:, i] += term
        val[:, i] /= denom
        der[:, i] /= denom
    return val, der


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def element_tables(p: int):
    """(stiffness [P^3, P^3] on [0,1]^3, load basis B [Q^3, P^3] at the
    QGauss(p+1) points, their points [Q^3, 3] and weights [Q^3]); local
    orders are x-fastest."""
    nodes = gll_nodes(p)
    xq, wq = gauss(p + 2)  # exact for the degree-2p products
    v, d = lagrange(nodes, xq)
    K1 = (d * wq[:, None]).T @ d
    M1 = (v * wq[:, None]).T @ v
    K = (np.kron(M1, np.kron(M1, K1)) + np.kron(M1, np.kron(K1, M1))
         + np.kron(K1, np.kron(M1, M1)))
    xl, wl = gauss(p + 1)
    vl, _ = lagrange(nodes, xl)
    B = np.kron(vl, np.kron(vl, vl))
    q = len(xl)
    flat = np.arange(q**3)
    pts = np.stack([xl[(flat // q**a) % q] for a in range(DIM)], axis=1)
    wts = wl[flat % q] * wl[(flat // q) % q] * wl[flat // q**2]
    return K, B, pts, wts


# ---------------------------------------------------------------------- mesh


@dataclass
class Octree:
    level: np.ndarray   # int64 [n]
    anchor: np.ndarray  # int64 [n, 3], in units of the cell's own level

    @property
    def max_level(self) -> int:
        return int(self.level.max())


_CHILD = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64)
_NEIGHBOURS = np.array(
    [[a, b, c] for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)],
    np.int64,
)


def _refine(t: Octree, flags: np.ndarray) -> Octree:
    par = t.anchor[flags]
    kids = (2 * par[:, None, :] + _CHILD[None]).reshape(-1, DIM)
    return Octree(
        np.concatenate([t.level[~flags], np.repeat(t.level[flags] + 1, 8)]),
        np.concatenate([t.anchor[~flags], kids]),
    )


def level_map(t: Octree, L: int) -> np.ndarray:
    """[2^L]^3 int8: the level of the cell covering each level-L voxel."""
    n = 1 << L
    lm = np.full((n, n, n), -1, np.int8)
    for q in np.unique(t.level):
        sel = t.level == q
        nq, f = 1 << int(q), 1 << (L - int(q))
        view = lm.reshape(nq, f, nq, f, nq, f).transpose(0, 2, 4, 1, 3, 5)
        a = t.anchor[sel]
        view[a[:, 0], a[:, 1], a[:, 2]] = q
    if (lm < 0).any():
        raise ValueError("the cells do not cover the domain")
    return lm


def _cell_keys(level: np.ndarray, anchor: np.ndarray) -> np.ndarray:
    return (level << 57) | (anchor[:, 0] << 38) | (anchor[:, 1] << 19) | anchor[:, 2]


def _coarse_neighbours(t: Octree, lm: np.ndarray, L: int, offsets: np.ndarray, m: int):
    """For the cells of level m: (cell index, offset index, level of the cell
    covering the neighbour box) of every neighbour box inside the domain."""
    idx = np.flatnonzero(t.level == m)
    nb = t.anchor[idx][:, None, :] + offsets[None, :, :]
    inside = np.all((nb >= 0) & (nb < (1 << m)), axis=2)
    ci, oi = np.nonzero(inside)
    corner = nb[ci, oi] << (L - m)
    lv = lm[corner[:, 0], corner[:, 1], corner[:, 2]].astype(np.int64)
    return idx[ci], oi, lv


def balance(t: Octree) -> Octree:
    """Refine until no cell shares even a corner with a cell two or more
    levels finer (p4est's full 2:1 balance)."""
    while True:
        L = t.max_level
        lm = level_map(t, L)
        keys = np.sort(_cell_keys(t.level, t.anchor))
        order = np.argsort(_cell_keys(t.level, t.anchor))
        flagged = []
        for m in range(2, L + 1):
            ci, oi, lv = _coarse_neighbours(t, lm, L, _NEIGHBOURS, m)
            bad = lv <= m - 2
            if not bad.any():
                continue
            corner = (t.anchor[ci[bad]] + _NEIGHBOURS[oi[bad]]) << (L - m)
            lvb = lv[bad]
            anc = corner >> (L - lvb)[:, None]
            flagged.append(order[np.searchsorted(keys, _cell_keys(lvb, anc))])
        if not flagged:
            return t
        flags = np.zeros(len(t.level), bool)
        flags[np.concatenate(flagged)] = True
        t = _refine(t, flags)


def _centers(t: Octree) -> np.ndarray:
    return -1.0 + 2.0 * (t.anchor + 0.5) / (1 << t.level)[:, None]


def _vertices(t: Octree) -> np.ndarray:
    return -1.0 + 2.0 * (t.anchor[:, None, :] + _CHILD[None]) / (1 << t.level)[:, None, None]


def _global(t: Octree, times: int) -> Octree:
    for _ in range(times):
        t = _refine(t, np.ones(len(t.level), bool))
    return t


def _octant(t: Octree) -> np.ndarray:
    # the cell's centre lies in the open all-negative octant
    return np.all(2 * t.anchor + 1 < (1 << t.level)[:, None], axis=1)


def build_mesh(family: str, n_ref_global: int, n_ref_local: int = 0) -> Octree:
    """The benchmark's mesh families (deal.II benchmark's grid_generator.h):
    hypercube, quadrant, quadrant_flexible, circle, annulus."""
    t = Octree(np.zeros(1, np.int64), np.zeros((1, DIM), np.int64))
    r = n_ref_global
    if family == "hypercube":
        return _global(t, r)
    if family == "quadrant":
        if r == 0:
            return t
        t = _global(t, 1)
        for _ in range(1, r):
            t = balance(_refine(t, _octant(t)))
        return t
    if family == "quadrant_flexible":
        t = _global(t, r)
        for _ in range(n_ref_local):
            t = balance(_refine(t, _octant(t)))
        return t
    if family == "circle":
        t = _global(t, min(r, 3))
        for _ in range(3, r):
            near = np.linalg.norm(_vertices(t), axis=2) < 1.0 / (4.0 * math.pi)
            t = balance(_refine(t, near.any(axis=1)))
        return t
    if family == "annulus":
        if r > 3:
            t = _global(t, r - 3)
        for k, (lo, hi) in enumerate([(-1.0, 0.55), (0.3, 0.43), (0.335, 0.39)]):
            if r < k + 1:
                break
            rad = np.linalg.norm(_centers(t), axis=1)
            flags = rad < hi if k == 0 else (lo <= rad) & (rad <= hi)
            t = balance(_refine(t, flags))
        return t
    raise ValueError(f"the reference has no mesh family {family!r}")


# ----------------------------------------------------------------- the space


class PoissonQ:
    """The constrained Q_p Poisson problem on an octree, on ``device``.

    Node values live on every distinct node position; the free nodes are
    those neither on the boundary nor hanging.  ``apply`` is the
    constrained operator on free-node vectors, ``load`` the constrained
    right-hand side of a simulation type."""

    def __init__(self, mesh: Octree, degree: int, device="cpu"):
        self.mesh, self.p, self.device = mesh, degree, torch.device(device)
        p = degree
        P = p + 1
        L = mesh.max_level
        self.L = L
        xi = gll_nodes(p)
        tau = xi - 0.5
        n_c = len(mesh.level)
        s = (1 << (L - mesh.level)).astype(np.int64)  # cell size in level-L units
        # exact per-axis position keys: a rational position 2*pos, or the
        # cell-interval centre with the symmetric Gauss-Lobatto index and the
        # signed cell size (the interior points are irrational)
        rational = np.zeros(P, bool)
        rational[[0, p]] = True
        if p % 2 == 0:
            rational[p // 2] = True
        a = np.arange(P)
        sym = np.minimum(a, p - a)
        sgn = np.sign(tau).astype(np.int64)
        half = np.rint(2 * tau).astype(np.int64) + 1  # 0, 1, 2 for xi = 0, 1/2, 1
        axis_keys = []
        axis_vals = []
        for j in range(DIM):
            c = mesh.anchor[:, j] * s
            pos2 = 2 * c[:, None] + half[None, :] * s[:, None]
            r2 = 2 * c[:, None] + s[:, None]
            key = np.where(
                rational[None, :],
                pos2 << 20,
                (r2 << 20) | (sym[None, :] << 16) | (sgn[None, :] * s[:, None] + (1 << 15)),
            )
            val = np.where(rational[None, :], 0.5 * pos2, 0.5 * r2 + tau[None, :] * s[:, None])
            axis_keys.append(key)
            axis_vals.append(val)
        ukeys, first = np.unique(np.concatenate([k.ravel() for k in axis_keys]), return_index=True)
        uvals = np.concatenate([v.ravel() for v in axis_vals])[first]
        rank = np.empty(len(ukeys), np.int64)
        rank[np.argsort(uvals)] = np.arange(len(ukeys))
        self.axis_values = -1.0 + (2.0 / (1 << L)) * np.sort(uvals)
        N = len(ukeys)
        self.N = N
        ix, iy, iz = (rank[np.searchsorted(ukeys, k)] for k in axis_keys)
        nkey = (ix[:, None, None, :] * (N * N) + iy[:, None, :, None] * N + iz[:, :, None, None]).reshape(n_c, P**3)
        self.node_keys, inverse = np.unique(nkey, return_inverse=True)
        cell_nodes = inverse.reshape(n_c, P**3)
        del nkey, inverse
        n_nodes = len(self.node_keys)
        self.n_nodes = n_nodes
        nk = self.node_keys
        idx3 = np.stack([nk // (N * N), (nk // N) % N, nk % N], axis=1)
        boundary = np.any((idx3 == 0) | (idx3 == N - 1), axis=1)

        # hanging nodes: a node of a cell F that lies on the closure of a
        # coarser neighbour C without being a node of C takes the value of
        # C's interpolant there
        lm = level_map(mesh, L)
        ckeys = _cell_keys(mesh.level, mesh.anchor)
        corder = np.argsort(ckeys)
        csorted = ckeys[corder]
        rows, cols, wts, pair = [], [], [], []
        n_pairs = 0
        for m in range(1, L + 1):
            fi, oi, lv = _coarse_neighbours(mesh, lm, L, _NEIGHBOURS, m)
            if (lv <= m - 2).any():
                raise ValueError("the mesh is not 2:1 balanced")
            sel = lv == m - 1
            fi, oi = fi[sel], oi[sel]
            if not len(fi):
                continue
            canc = (mesh.anchor[fi] + _NEIGHBOURS[oi]) >> 1
            cidx = corder[np.searchsorted(csorted, _cell_keys(np.full(len(fi), m - 1), canc))]
            rel = mesh.anchor[fi] - 2 * canc  # F's place in C, in F units: -1..2
            groups, ginv = np.unique(rel, axis=0, return_inverse=True)
            for g, o in enumerate(groups):
                members = np.flatnonzero(ginv.ravel() == g)
                t = [(o[j] + xi) / 2.0 for j in range(DIM)]  # F's node coords in C
                inside = [(tj >= -1e-14) & (tj <= 1 + 1e-14) for tj in t]
                vals = [lagrange(xi, np.clip(tj, 0.0, 1.0))[0] for tj in t]
                loc = []
                for kz in np.flatnonzero(inside[2]):
                    for ky in np.flatnonzero(inside[1]):
                        for kx in np.flatnonzero(inside[0]):
                            w = np.kron(vals[2][kz], np.kron(vals[1][ky], vals[0][kx]))
                            w[np.abs(w) < 1e-14] = 0.0
                            if np.count_nonzero(w) == 1 and abs(w.max() - 1.0) < 1e-12:
                                continue  # the node is one of C's nodes
                            loc.append((kx + P * ky + P * P * kz, w))
                for li, w in loc:
                    nzk = np.flatnonzero(w)
                    slave = cell_nodes[fi[members], li]
                    rows.append(np.repeat(slave, len(nzk)))
                    cols.append(cell_nodes[cidx[members]][:, nzk].ravel())
                    wts.append(np.tile(w[nzk], len(members)))
                    pair.append(np.repeat(n_pairs + members, len(nzk)))
            n_pairs += len(fi)
        if rows:
            rows, cols = np.concatenate(rows), np.concatenate(cols)
            wts, pair = np.concatenate(wts), np.concatenate(pair)
            # one row per hanging node (every coarse cell that holds it gives
            # the same interpolant): keep the first pair's
            first_pair = np.full(n_nodes, np.iinfo(np.int64).max)
            np.minimum.at(first_pair, rows, pair)
            keep = pair == first_pair[rows]
            rows, cols, wts = rows[keep], cols[keep], wts[keep]
        else:
            rows = cols = np.zeros(0, np.int64)
            wts = np.zeros(0)
        hanging = np.zeros(n_nodes, bool)
        hanging[rows] = True
        W = sp.csr_matrix((wts, (rows, cols)), shape=(n_nodes, n_nodes))
        # a master may hang itself (on a coarser cell's edge): substitute
        # until every master is a non-hanging node
        R = W
        for _ in range(16):
            Rh = R.multiply(hanging[None, :].astype(np.float64)).tocsr()
            Rh.eliminate_zeros()
            if Rh.nnz == 0:
                break
            R = (R - Rh + Rh @ W).tocsr()
            R.eliminate_zeros()
        else:
            raise ValueError("hanging-node constraints do not resolve")
        self.hanging = np.flatnonzero(hanging)
        self.boundary = boundary
        self.free = np.flatnonzero(~hanging & ~boundary)
        self.n_free = len(self.free)
        Rs = R[self.hanging].tocoo()  # [n_hanging, n_nodes], masters not hanging
        self.n_hanging = len(self.hanging)

        dev = self.device
        K, B, qpts, qwts = element_tables(p)
        self._K = torch.as_tensor(K, dtype=torch.float64, device=dev)
        self._B = torch.as_tensor(B, dtype=torch.float64, device=dev)
        self._qpts = torch.as_tensor(qpts, dtype=torch.float64, device=dev)
        self._qwts = torch.as_tensor(qwts, dtype=torch.float64, device=dev)
        h = 2.0 / (1 << mesh.level).astype(np.float64)
        self._h = torch.as_tensor(h, dtype=torch.float64, device=dev)
        self._lo = torch.as_tensor(-1.0 + mesh.anchor * h[:, None], dtype=torch.float64, device=dev)
        self._cells = torch.as_tensor(cell_nodes, dtype=torch.int64, device=dev)
        self._R = torch.sparse_coo_tensor(
            np.stack([Rs.row, Rs.col]), Rs.data, (self.n_hanging, n_nodes),
            dtype=torch.float64, device=dev, check_invariants=False,
        ).coalesce()
        self._RT = self._R.t().coalesce()
        self._hang = torch.as_tensor(self.hanging, dtype=torch.int64, device=dev)
        self._free = torch.as_tensor(self.free, dtype=torch.int64, device=dev)
        self._boundary = torch.as_tensor(np.flatnonzero(boundary & ~hanging), dtype=torch.int64, device=dev)
        self._idx3 = idx3

    # -------------------------------------------------------------- helpers
    def node_points(self, nodes: np.ndarray | None = None) -> np.ndarray:
        idx = self._idx3 if nodes is None else self._idx3[nodes]
        return self.axis_values[idx]

    def _distribute(self, u: torch.Tensor) -> torch.Tensor:
        if self.n_hanging:
            u[self._hang] = torch.sparse.mm(self._R, u[:, None])[:, 0]
        return u

    def _gather_ct(self, y: torch.Tensor) -> torch.Tensor:
        if self.n_hanging:
            y = y + torch.sparse.mm(self._RT, y[self._hang][:, None])[:, 0]
        return y

    def _apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(u)
        for a in range(0, self._cells.shape[0], _BLOCK):
            cn = self._cells[a:a + _BLOCK]
            yc = (u[cn] @ self._K) * self._h[a:a + _BLOCK, None]
            y.index_add_(0, cn.reshape(-1), yc.reshape(-1))
        return y

    # ----------------------------------------------------------------- API
    def apply(self, x_free: torch.Tensor) -> torch.Tensor:
        """The constrained operator on a free-node vector (float64)."""
        u = torch.zeros(self.n_nodes, dtype=torch.float64, device=self.device)
        u[self._free] = x_free.to(torch.float64)
        y = self._gather_ct(self._apply_raw(self._distribute(u)))
        return y[self._free]

    def load(self, simulation_type: str) -> torch.Tensor:
        """The constrained right-hand side of "Constant" (f = 1) or
        "Gaussian" (f = -laplace of the Gaussian, its boundary values lifted)
        on the free nodes, float64."""
        dev = self.device
        F = torch.zeros(self.n_nodes, dtype=torch.float64, device=dev)
        lift = torch.zeros_like(F)
        for a in range(0, self._cells.shape[0], _BLOCK):
            h = self._h[a:a + _BLOCK]
            pts = self._lo[a:a + _BLOCK, None, :] + h[:, None, None] * self._qpts[None]
            f = _rhs(simulation_type, pts)
            fc = (f * self._qwts[None] * h[:, None] ** DIM) @ self._B
            F.index_add_(0, self._cells[a:a + _BLOCK].reshape(-1), fc.reshape(-1))
        if simulation_type == "Gaussian":
            pts = torch.as_tensor(self.node_points(self._boundary.cpu().numpy()), device=dev)
            lift[self._boundary] = gaussian_solution(pts)
            F = F - self._apply_raw(self._distribute(lift))
        return self._gather_ct(F)[self._free]

    def node_index(self, points: np.ndarray) -> np.ndarray:
        """The node of each of ``points`` [n, 3]; raises ValueError where a
        point is no node of the mesh or a free node is given no point."""
        pts = np.asarray(points, np.float64)
        av = self.axis_values
        k = np.clip(np.searchsorted(av, pts), 1, len(av) - 1)
        near = np.where(np.abs(av[k - 1] - pts) <= np.abs(av[k] - pts), k - 1, k)
        if not np.all(np.abs(av[near] - pts) <= 1e-9):
            raise ValueError("a point lies off the mesh's node lattice")
        N = self.N
        key = near[:, 0] * (N * N) + near[:, 1] * N + near[:, 2]
        pos = np.clip(np.searchsorted(self.node_keys, key), 0, len(self.node_keys) - 1)
        if not np.all(self.node_keys[pos] == key):
            raise ValueError(f"{int(np.sum(self.node_keys[pos] != key))} points are no node of the mesh")
        given = np.zeros(self.n_nodes, bool)
        given[pos] = True
        if not given[self.free].all():
            raise ValueError(f"{int((~given[self.free]).sum())} free nodes are given no point")
        return pos

    def take(self, index: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Values given at the points of ``node_index`` on the free nodes
        (where two points share a node, the later one's)."""
        out = np.zeros(self.n_nodes)
        out[index] = values
        return out[self.free]


def gaussian_solution(x: torch.Tensor) -> torch.Tensor:
    d2 = torch.sum((x - GAUSS_CENTER) ** 2, -1)
    return torch.exp(-d2 / GAUSS_WIDTH**2) / (math.sqrt(2.0 * math.pi) * GAUSS_WIDTH) ** DIM


def _rhs(simulation_type: str, x: torch.Tensor) -> torch.Tensor:
    if simulation_type == "Constant":
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    if simulation_type == "Gaussian":
        d2 = torch.sum((x - GAUSS_CENTER) ** 2, -1)
        w2 = GAUSS_WIDTH**2
        norm = (math.sqrt(2.0 * math.pi) * GAUSS_WIDTH) ** DIM
        return ((2 * DIM - 4 * d2 / w2) / w2) * torch.exp(-d2 / w2) / norm
    raise ValueError(f"unknown simulation type {simulation_type!r}")
