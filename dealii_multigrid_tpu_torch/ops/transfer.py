"""Two-level multigrid transfers (h and p) of the gather engine, on torch.

Mirror of the JAX package's ops/transfer.py (deal.II's MGTwoLevelTransfer +
MGTransferGlobalCoarsening as the reference uses them,
multigrid_throughput.cc:1600-1621).  At set-up every fine cell is matched to
its coarse source cell by Morton code on the host and bucketed by child
octant (or ``identity`` where the cell is active on both levels, or the
p-embedding for a polynomial transfer).  Prolongation is, per bucket,
``gather coarse cell DoFs -> GEMM with the bucket's (n_loc_f x n_loc_c)
embedding -> 1/valence weights``, and one fixed-order sum
(ops/fixed_order.py) over all buckets' outputs assembles the fine vector;
restriction is the exact transpose, with its own table over the coarse
DoFs.  The 1/valence weights keep both directions adjoint and prolongation
exact nodal interpolation of the constraint-distributed coarse function.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.dof import DoFHandler
from ..mesh.octree import morton_encode
from . import tensor
from .fixed_order import FixedOrderSum
from .operator import ConstraintTable, LaplaceOperator, distribute, distribute_transpose


@dataclass(frozen=True)
class TransferBucket:
    fine_cells: torch.Tensor    # int64 [nb] indices into the fine cell list
    coarse_cells: torch.Tensor  # int64 [nb] indices into the coarse cell list
    matrix: torch.Tensor        # [n_loc_f, n_loc_c]
    fine_dofs: torch.Tensor     # int64 [nb, n_loc_f] = fine cell_dofs[fine_cells]
    coarse_dofs: torch.Tensor   # int64 [nb, n_loc_c] = coarse cell_dofs[coarse_cells]


@dataclass(frozen=True)
class TwoLevelTransfer:
    """prolong: coarse -> fine; restrict: fine -> coarse (exact adjoint)."""

    buckets: tuple
    fine_weight: torch.Tensor        # [n_dofs_f] 1/valence
    fine_constrained: torch.Tensor   # Dirichlet + hanging on the fine level
    coarse_hanging: ConstraintTable
    coarse_dirichlet: torch.Tensor
    n_dofs_fine: int
    n_dofs_coarse: int
    prolong_sum: FixedOrderSum       # buckets' fine slots -> fine DoFs
    restrict_sum: FixedOrderSum      # buckets' coarse slots -> coarse DoFs

    def prolong(self, u_c: torch.Tensor) -> torch.Tensor:
        # zero coarse Dirichlet first so prolong/restrict are exact adjoints
        # (C_c = distribute o zero, C_c^T = zero o distribute^T)
        if self.coarse_dirichlet.shape[0]:
            u_c = u_c.clone()
            u_c.index_fill_(0, self.coarse_dirichlet, 0)
        u = distribute(u_c, self.coarse_hanging)
        parts = [
            (torch.matmul(u[b.coarse_dofs], b.matrix.T) * self.fine_weight[b.fine_dofs]).reshape(-1)
            for b in self.buckets
        ]
        out = self.prolong_sum.scatter(torch.cat(parts))
        if self.fine_constrained.shape[0]:
            out.index_fill_(0, self.fine_constrained, 0)
        return out

    def restrict(self, r_f: torch.Tensor) -> torch.Tensor:
        if self.fine_constrained.shape[0]:
            r_f = r_f.clone()
            r_f.index_fill_(0, self.fine_constrained, 0)
        rw = r_f * self.fine_weight
        parts = [torch.matmul(rw[b.fine_dofs], b.matrix).reshape(-1) for b in self.buckets]
        acc = distribute_transpose(self.restrict_sum.scatter(torch.cat(parts)), self.coarse_hanging)
        if self.coarse_dirichlet.shape[0]:
            acc.index_fill_(0, self.coarse_dirichlet, 0)
        return acc


def _embedding_matrix(dim: int, degree: int, octant: int) -> np.ndarray:
    """Tensor-product h-embedding for one child octant (x-fastest kron order)."""
    E = tensor.h_embedding_1d(degree)
    out = np.array([[1.0]])
    for d in range(dim):
        out = np.kron(E[(octant >> d) & 1], out)
    return out


def _p_embedding_matrix(dim: int, deg_c: int, deg_f: int) -> np.ndarray:
    E = tensor.p_embedding_1d(deg_c, deg_f)
    out = np.array([[1.0]])
    for _ in range(dim):
        out = np.kron(E, out)
    return out


def transfer_buckets(fine: DoFHandler, coarse: DoFHandler) -> list:
    """(fine cells, coarse cells, embedding) per bucket, on the host.

    Same mesh and different degree: one polynomial bucket.  Different mesh
    and same degree: an identity bucket for the cells active on both levels
    and one bucket per child octant for the rest (the coarse mesh must be
    one global-coarsening step of the fine one)."""
    dim = fine.dim
    mf, mc = fine.mesh, coarse.mesh
    same_mesh = (
        mf.n_cells == mc.n_cells
        and mf.max_level == mc.max_level
        and np.array_equal(mf.level, mc.level)
        and np.array_equal(mf.anchor, mc.anchor)
    )
    if same_mesh:
        if fine.degree == coarse.degree:
            raise ValueError("no-op transfer: same mesh and same degree")
        cells = np.arange(mf.n_cells, dtype=np.int64)
        return [(cells, cells, _p_embedding_matrix(dim, coarse.degree, fine.degree))]
    if fine.degree != coarse.degree:
        raise ValueError("h-transfer requires equal degrees")
    # each fine cell's coarse cell: identity (the same cell active on the
    # coarse mesh) or parent (one level coarser)
    cindex = {}
    for l in np.unique(mc.level):
        sel = np.nonzero(mc.level == l)[0]
        codes = morton_encode(mc.anchor[sel])
        order = np.argsort(codes)
        cindex[int(l)] = (codes[order], sel[order])

    def lookup(level, anchors):
        got = cindex.get(int(level))
        if got is None:
            return np.full(len(anchors), -1, np.int64)
        codes_sorted, gidx = got
        q = morton_encode(anchors)
        pos = np.minimum(np.searchsorted(codes_sorted, q), len(codes_sorted) - 1)
        return np.where(codes_sorted[pos] == q, gidx[pos], -1)

    buckets = []
    ident = np.full(mf.n_cells, -1, np.int64)
    for l in np.unique(mf.level):
        sel = np.nonzero(mf.level == l)[0]
        ident[sel] = lookup(l, mf.anchor[sel])
    id_cells = np.nonzero(ident >= 0)[0]
    if len(id_cells):
        buckets.append((id_cells, ident[id_cells], np.eye(fine.n_loc)))
    rest = np.nonzero(ident < 0)[0]
    if len(rest):
        par = np.full(len(rest), -1, np.int64)
        oct_ = np.zeros(len(rest), np.int64)
        for l in np.unique(mf.level[rest]):
            s = mf.level[rest] == l
            cells = rest[s]
            par[s] = lookup(l - 1, mf.anchor[cells] >> 1)
            bits = mf.anchor[cells] & 1
            oct_[s] = sum(bits[:, d] << d for d in range(dim))
        if (par < 0).any():
            raise ValueError("fine cell without coarse source cell")
        for o in range(1 << dim):
            s = oct_ == o
            if s.any():
                buckets.append((rest[s], par[s], _embedding_matrix(dim, fine.degree, o)))
    return buckets


def make_two_level_transfer(
    fine: DoFHandler,
    coarse: DoFHandler,
    fine_op: LaplaceOperator,
    coarse_op: LaplaceOperator,
    dtype: torch.dtype = torch.float32,
) -> TwoLevelTransfer:
    """The transfer between two level DoFHandlers, on the operators' device."""
    device = fine_op.device
    buckets = transfer_buckets(fine, coarse)
    valence = np.bincount(fine.cell_dofs.reshape(-1), minlength=fine.n_dofs)
    fdofs = [fine.cell_dofs[fc].astype(np.int64) for fc, _, _ in buckets]
    cdofs = [coarse.cell_dofs[cc].astype(np.int64) for _, cc, _ in buckets]

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return TwoLevelTransfer(
        buckets=tuple(
            TransferBucket(
                idx(fc), idx(cc), torch.as_tensor(M, dtype=dtype, device=device),
                idx(fd), idx(cd),
            )
            for (fc, cc, M), fd, cd in zip(buckets, fdofs, cdofs)
        ),
        fine_weight=torch.as_tensor(1.0 / np.maximum(valence, 1), dtype=dtype, device=device),
        fine_constrained=fine_op.constrained,
        coarse_hanging=coarse_op.hanging,
        coarse_dirichlet=coarse_op.dirichlet,
        n_dofs_fine=fine.n_dofs,
        n_dofs_coarse=coarse.n_dofs,
        prolong_sum=FixedOrderSum.build(np.concatenate(fdofs), fine.n_dofs, device),
        restrict_sum=FixedOrderSum.build(np.concatenate(cdofs), coarse.n_dofs, device),
    )
