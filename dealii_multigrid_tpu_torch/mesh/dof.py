"""DoF enumeration and constraint algebra for continuous Q_p spaces on
adaptive 2:1-balanced quad/octree meshes.

Equivalent capability to deal.II's DoFHandler + AffineConstraints +
DoFTools::make_hanging_node_constraints + VectorTools::interpolate_boundary_values
(reference usage: multigrid_throughput.cc:2262-2312), re-designed for TPU
consumption: the output is flat integer gather maps and padded constraint
tables, computed vectorised on the host.

DoF identification follows deal.II's topological rule: a node is keyed by the
mesh entity it lies on (vertex / edge / face / cell interior).  Vertices unify
purely geometrically across levels; higher-dimensional entities unify only at
equal refinement level, so hanging nodes remain distinct DoFs that receive
constraint rows (interpolation from the coarse side's face/edge), exactly as
AffineConstraints stores them.  This reproduces deal.II's n_dofs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..ops import tensor
from .octree import AdaptiveMesh, morton_encode
from ..utils.phases import setup_span


def local_node_indices(dim: int, degree: int) -> np.ndarray:
    """All (p+1)^dim local node multi-indices, x fastest: [n_loc, dim]."""
    n = degree + 1
    flat = np.arange(n**dim)
    out = np.empty((n**dim, dim), dtype=np.int64)
    for d in range(dim):
        out[:, d] = (flat // n**d) % n
    return out


@dataclass
class DoFHandler:
    mesh: AdaptiveMesh
    degree: int
    n_dofs: int
    cell_dofs: np.ndarray      # [n_cells, (p+1)^dim] int32, x-fastest local order
    points: np.ndarray         # [n_dofs, dim] physical node positions (float64)
    boundary_mask: np.ndarray  # [n_dofs] bool — node on the domain boundary

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def n_loc(self) -> int:
        return (self.degree + 1) ** self.dim


def _pack_rows(cols: list[np.ndarray], bits: list[int]):
    """Pack integer columns into one int64 key if possible, else a void view."""
    total = sum(bits)
    if total <= 63:
        key = np.zeros(len(cols[0]), dtype=np.int64)
        shift = 0
        for c, b in zip(reversed(cols), reversed(bits)):
            key |= c.astype(np.int64) << shift
            shift += b
        return key
    stacked = np.ascontiguousarray(np.stack(cols, axis=1).astype(np.int64))
    return stacked.view([("", np.int64)] * stacked.shape[1]).reshape(-1)


@setup_span("mgtpu.setup.dofs")
def distribute_dofs(mesh: AdaptiveMesh, degree: int) -> DoFHandler:
    """Enumerate global DoFs of the continuous Q_degree space on ``mesh``."""
    dim, p = mesh.dim, degree
    L = mesh.max_level
    if dim == 3:
        # fused native path (native/dofs.cc): identical key packing and
        # numbering, one pass instead of ~15 volume-sized NumPy passes
        from .native import distribute_dofs_native

        got = distribute_dofs_native(
            mesh.level, mesh.anchor, p, L,
            tensor.gauss_lobatto_points(p + 1), mesh.lower, mesh.upper,
        )
        if got is not None:
            n_dofs, cell_dofs, points, boundary_mask = got
            return DoFHandler(mesh, p, n_dofs, cell_dofs, points, boundary_mask)
    loc = local_node_indices(dim, p)            # [n_loc, dim]
    n_loc = len(loc)
    lvl = mesh.level.astype(np.int64)
    shift = (L - lvl)[:, None, None]            # [n_cells,1,1]

    # pseudo-equispaced integer key per axis on the lattice [0, p * 2^L]
    g = (mesh.anchor[:, None, :] * p + loc[None, :, :]) << shift  # [n_cells, n_loc, dim]

    interior = (loc > 0) & (loc < p)            # [n_loc, dim]
    mask = np.zeros(n_loc, dtype=np.int64)
    for d in range(dim):
        mask |= interior[:, d].astype(np.int64) << d
    is_vertex = mask == 0
    ent_level = np.where(is_vertex[None, :], 0, lvl[:, None] + 1)  # 0 reserved for vertices

    gb = int(p << L).bit_length()
    cols = [g[:, :, d].reshape(-1) for d in range(dim)]
    cols.append(np.broadcast_to(mask[None, :], g.shape[:2]).reshape(-1))
    cols.append(ent_level.reshape(-1))
    keys = _pack_rows(cols, [gb] * dim + [dim, 6])

    from .native import unique_inverse

    first, inverse = unique_inverse(keys)
    n_dofs = len(first)
    cell_dofs = inverse.reshape(-1, n_loc).astype(np.int32)

    # geometric positions (true Gauss-Lobatto) and boundary mask
    gl = tensor.gauss_lobatto_points(p + 1)
    size = 1.0 / (1 << lvl)
    pos_unit = (mesh.anchor[:, None, :] + gl[loc][None, :, :]) * size[:, None, None]
    pos = mesh.lower + (mesh.upper - mesh.lower) * pos_unit
    points = pos.reshape(-1, dim)[first]

    gflat = g.reshape(-1, dim)[first]
    boundary_mask = np.any((gflat == 0) | (gflat == (p << L)), axis=1)

    return DoFHandler(mesh, p, n_dofs, cell_dofs, points, boundary_mask)


# --------------------------------------------------------------------------
# hanging-node constraints
# --------------------------------------------------------------------------

@dataclass
class Constraints:
    """Closed hanging-node constraint table: u[slave] = sum_k w_k u[master_k].

    Equivalent of a closed AffineConstraints object restricted to hanging
    nodes (reference: DoFTools::make_hanging_node_constraints at
    multigrid_throughput.cc:2305-2312).  Padded to fixed width for the device.
    """

    n_dofs: int
    slave: np.ndarray     # [n_slaves] int32 (sorted)
    masters: np.ndarray   # [n_slaves, K] int32 (padded with 0)
    weights: np.ndarray   # [n_slaves, K] float64 (padded with 0)

    @property
    def n_slaves(self) -> int:
        return len(self.slave)

    def slave_mask(self) -> np.ndarray:
        m = np.zeros(self.n_dofs, dtype=bool)
        m[self.slave] = True
        return m

    def as_sparse(self) -> sp.csr_matrix:
        """The full distribution matrix C (n_dofs x n_dofs): identity on
        unconstrained rows, interpolation on slave rows."""
        eye = sp.eye(self.n_dofs, format="lil")
        for i, s in enumerate(self.slave):
            eye.rows[s] = []
            eye.data[s] = []
        C = eye.tocsr()
        rows = np.repeat(self.slave, self.masters.shape[1])
        cols = self.masters.reshape(-1)
        vals = self.weights.reshape(-1)
        nz = vals != 0
        C = C + sp.csr_matrix(
            (vals[nz], (rows[nz], cols[nz])), shape=(self.n_dofs, self.n_dofs)
        )
        return C


def _active_lookup(mesh: AdaptiveMesh):
    idx = mesh.active_index()

    def find(level: int, anchor: np.ndarray) -> np.ndarray:
        codes_sorted, gidx = idx[int(level)]
        q = morton_encode(anchor)
        pos = np.searchsorted(codes_sorted, q)
        return gidx[pos]

    return find


@setup_span("mgtpu.setup.hanging")
def make_hanging_node_constraints(dofh: DoFHandler) -> Constraints:
    """Build and transitively close the hanging-node constraint rows."""
    mesh, p, dim = dofh.mesh, dofh.degree, dofh.dim
    n1 = p + 1
    loc = local_node_indices(dim, p)
    find_cell = _active_lookup(mesh)
    E = tensor.h_embedding_1d(p)  # E[b][i, j] = l_j((gl_i + b)/2)

    rows_slave: list[np.ndarray] = []
    rows_masters: list[np.ndarray] = []
    rows_weights: list[np.ndarray] = []

    def local_flat(ii: np.ndarray) -> np.ndarray:
        """Flatten per-axis local indices [n.., dim] to x-fastest flat index."""
        out = np.zeros(ii.shape[:-1], dtype=np.int64)
        for d in range(dim):
            out += ii[..., d] * (n1**d)
        return out

    levels = [int(l) for l in np.unique(mesh.level) if l >= 1]

    # ---- face constraints ------------------------------------------------
    for d in range(dim):
        trans = [e for e in range(dim) if e != d]
        # face-node local multi-indices of the fine cell, per side
        for side in (0, 1):
            sel_face = loc[:, d] == side * p
            fnodes = loc[sel_face]                       # [(p+1)^(dim-1), dim]
            for m in levels:
                cells = np.nonzero(mesh.level == m)[0]
                if len(cells) == 0:
                    continue
                a = mesh.anchor[cells]
                nb = a.copy()
                nb[:, d] += 2 * side - 1
                valid = (nb[:, d] >= 0) & (nb[:, d] < (1 << m))
                cov = np.full(len(cells), -1, dtype=np.int32)
                cov[valid] = mesh.covering_cell_level(m, nb[valid], m - 1)
                hang = cov == m - 1
                if not hang.any():
                    continue
                F = cells[hang]
                aF = a[hang]
                Cidx = find_cell(m - 1, nb[hang] >> 1)
                b = (aF & 1)                              # child position in parent/coarse
                # slave dofs: fine face nodes
                slave = dofh.cell_dofs[F][:, sel_face]    # [nf, n_face]
                # master dofs: coarse face nodes at i_d = (1-side)*p
                sel_cface = loc[:, d] == (1 - side) * p
                cnodes = loc[sel_cface]
                master = dofh.cell_dofs[Cidx][:, sel_cface]  # [nf, n_face]
                # weights: tensor product over transverse axes
                W = np.ones((len(F), fnodes.shape[0], cnodes.shape[0]))
                for e in trans:
                    # E[b_e][i_e, j_e] for each cell
                    We = E[b[:, e]][:, fnodes[:, e], :][:, :, cnodes[:, e]]
                    W = W * We
                rows_slave.append(slave.reshape(-1))
                nfc = cnodes.shape[0]
                rows_masters.append(
                    np.broadcast_to(master[:, None, :], W.shape).reshape(-1, nfc)
                )
                rows_weights.append(W.reshape(-1, nfc))

    # ---- edge constraints (3D) -------------------------------------------
    if dim == 3:
        for t in range(3):
            u, v = [e for e in range(3) if e != t]
            sel_idx = {}
            for bu in (0, 1):
                for bv in (0, 1):
                    selm = (loc[:, u] == bu * p) & (loc[:, v] == bv * p)
                    sel_idx[(bu, bv)] = selm
            for bu in (0, 1):
                for bv in (0, 1):
                    sel_edge = sel_idx[(bu, bv)]
                    enodes = loc[sel_edge]              # [p+1, 3] along axis t
                    order_f = np.argsort(enodes[:, t])
                    for m in levels:
                        cells = np.nonzero(mesh.level == m)[0]
                        if len(cells) == 0:
                            continue
                        a = mesh.anchor[cells]
                        nb = a.copy()
                        nb[:, u] += 2 * bu - 1
                        nb[:, v] += 2 * bv - 1
                        valid = (
                            (nb[:, u] >= 0) & (nb[:, u] < (1 << m))
                            & (nb[:, v] >= 0) & (nb[:, v] < (1 << m))
                        )
                        cov = np.full(len(cells), -1, dtype=np.int32)
                        cov[valid] = mesh.covering_cell_level(m, nb[valid], m - 1)
                        hang = cov == m - 1
                        if not hang.any():
                            continue
                        F = cells[hang]
                        aF = a[hang]
                        Cidx = find_cell(m - 1, nb[hang] >> 1)
                        bt = aF[:, t] & 1
                        slave = dofh.cell_dofs[F][:, sel_edge][:, order_f]
                        sel_cedge = sel_idx[((1 - bu), (1 - bv))]
                        cn = loc[sel_cedge]
                        order_c = np.argsort(cn[:, t])
                        master = dofh.cell_dofs[Cidx][:, sel_cedge][:, order_c]
                        W = E[bt]                        # [nf, p+1(i_t), p+1(j_t)]
                        rows_slave.append(slave.reshape(-1))
                        rows_masters.append(
                            np.broadcast_to(master[:, None, :], W.shape).reshape(-1, n1)
                        )
                        rows_weights.append(W.reshape(-1, n1))

    if not rows_slave:
        return Constraints(
            dofh.n_dofs,
            np.zeros(0, np.int32),
            np.zeros((0, 1), np.int32),
            np.zeros((0, 1)),
        )

    # ---- assemble, drop identities, dedupe, close -------------------------
    width = max(r.shape[1] for r in rows_masters)
    slave = np.concatenate(rows_slave).astype(np.int64)
    masters = np.concatenate(
        [np.pad(r, ((0, 0), (0, width - r.shape[1]))) for r in rows_masters]
    ).astype(np.int64)
    weights = np.concatenate(
        [np.pad(r, ((0, 0), (0, width - r.shape[1]))) for r in rows_weights]
    )
    weights[np.abs(weights) < 1e-13] = 0.0

    # drop rows whose slave is one of its own masters (entity-identified
    # corner vertices: the interpolation is exactly the identity there)
    self_ref = np.any((masters == slave[:, None]) & (weights != 0), axis=1)
    slave, masters, weights = slave[~self_ref], masters[~self_ref], weights[~self_ref]

    # dedupe by slave id (duplicated rows from adjacent fine cells agree)
    _, keep = np.unique(slave, return_index=True)
    slave, masters, weights = slave[keep], masters[keep], weights[keep]

    # transitive closure via sparse substitution
    n = dofh.n_dofs
    rows = np.repeat(np.arange(len(slave)), width)
    nz = weights.reshape(-1) != 0
    R = sp.csr_matrix(
        (weights.reshape(-1)[nz], (rows[nz], masters.reshape(-1)[nz])),
        shape=(len(slave), n),
    )
    slave_mask = np.zeros(n, dtype=bool)
    slave_mask[slave] = True
    # S maps slave-row index -> global slave dof
    for _ in range(64):
        cols_are_slaves = slave_mask[R.indices]
        if not cols_are_slaves.any():
            break
        Rs = R.multiply(
            sp.csr_matrix(
                (cols_are_slaves.astype(np.float64), R.indices, R.indptr),
                shape=R.shape,
            )
        ).tocsr()
        Rn = R - Rs
        # substitute: contributions through slave columns -> their masters
        sel = sp.csr_matrix(
            (np.ones(len(slave)), (slave, np.arange(len(slave)))), shape=(n, len(slave))
        )
        R = (Rn + Rs @ sel @ R).tocsr()
        R.eliminate_zeros()
    else:  # pragma: no cover
        raise RuntimeError("constraint closure did not terminate")

    # back to padded form
    R = R.tocsr()
    counts = np.diff(R.indptr)
    K = max(int(counts.max()), 1)
    n_s = len(slave)
    masters_p = np.zeros((n_s, K), dtype=np.int32)
    weights_p = np.zeros((n_s, K))
    rows_i = np.repeat(np.arange(n_s), counts)
    cols_i = np.arange(len(R.indices)) - np.repeat(R.indptr[:-1], counts)
    masters_p[rows_i, cols_i] = R.indices
    weights_p[rows_i, cols_i] = R.data

    order = np.argsort(slave)
    return Constraints(
        n, slave[order].astype(np.int32), masters_p[order], weights_p[order]
    )
