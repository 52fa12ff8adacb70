"""Matrix-free Laplace operator of the gather engine, and its host helpers.

Capability mirror of the reference's ``Operator<dim, n_components, Number>``
(include/operator.h:11-557): constrained vmult with identity on constrained
DoFs and the inverse-diagonal computation.  The cell loop is ``gather ->
[n_cells, n_loc] @ [n_loc, n_loc] GEMM (one Cartesian reference element
matrix) -> fixed-order row sums`` (ops/fixed_order.py: a float32 apply is
bit-repeatable on CUDA); constraints are separate padded gather and scatter
passes over the (few) constrained DoFs.  The hybrid patch engine
(ops/hybrid.py) is the fast path in 3D; this operator carries the "AMG" and
"AMGPETSc" solver types, in 2D and 3D.  ``split_boundary_constraints`` and
the exact constrained diagonal ``compute_diagonal`` serve both engines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.dof import Constraints, DoFHandler
from . import element
from .fixed_order import FixedOrderSum


@dataclass(frozen=True)
class ConstraintTable:
    """Padded hanging-node constraint table on the device.

    u[slave] = sum_k weights[., k] * u[masters[., k]]; padding entries carry
    master 0 and weight 0.  ``master_sum`` gathers the transpose's
    contributions per master in a fixed order.
    """

    slave: torch.Tensor    # int64 [n_s]
    masters: torch.Tensor  # int64 [n_s, K]
    weights: torch.Tensor  # float [n_s, K]
    master_sum: FixedOrderSum


def distribute(u: torch.Tensor, ct: ConstraintTable) -> torch.Tensor:
    """Set slave entries from their masters (AffineConstraints::distribute)."""
    if ct.slave.shape[0] == 0:
        return u
    vals = (ct.weights * u[ct.masters]).sum(dim=-1)
    out = u.clone()
    out[ct.slave] = vals.to(u.dtype)
    return out


def distribute_transpose(r: torch.Tensor, ct: ConstraintTable) -> torch.Tensor:
    """Transpose: move slave residuals to their masters, zero the slaves."""
    if ct.slave.shape[0] == 0:
        return r
    contrib = (ct.weights * r[ct.slave][:, None]).to(r.dtype)
    out = r.clone()
    out[ct.slave] = 0
    return ct.master_sum.add_into(out, contrib.reshape(-1))


@dataclass(frozen=True)
class LaplaceOperator:
    """Constrained matrix-free Laplacian: vmult(u) = C^T A C u + I_c u.

    Semantics match reference include/operator.h:152-183 — constrained DoFs
    (Dirichlet + hanging) see the identity; the PDE acts on the rest.
    """

    cell_dofs: torch.Tensor     # int64 [n_cells, n_loc]
    cell_sum: FixedOrderSum     # cell slots -> DoFs, in a fixed order
    scale: torch.Tensor         # float [n_cells] — h^(dim-2)
    elem: torch.Tensor          # float [n_loc, n_loc] — reference stiffness (symmetric)
    hanging: ConstraintTable
    dirichlet: torch.Tensor     # int64 [n_d] — Dirichlet DoF indices
    constrained: torch.Tensor   # int64 [n_c] — Dirichlet + hanging slave indices
    n_dofs: int

    @property
    def dtype(self) -> torch.dtype:
        return self.scale.dtype

    @property
    def device(self) -> torch.device:
        return self.scale.device

    def cell_apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """A_raw u: the unconstrained FE Laplacian (no constraint algebra)."""
        rcell = torch.matmul(u[self.cell_dofs], self.elem) * self.scale[:, None]
        return self.cell_sum.scatter(rcell.reshape(-1))

    def apply_c(self, u: torch.Tensor) -> torch.Tensor:
        # zero Dirichlet first: hanging masters may be boundary DoFs, and the
        # homogeneous operator must see them as 0 (C = distribute ∘ zero).
        if self.dirichlet.shape[0]:
            u = u.clone()
            u[self.dirichlet] = 0
        return distribute(u, self.hanging)

    def apply_ct(self, r: torch.Tensor) -> torch.Tensor:
        r = distribute_transpose(r, self.hanging)
        if self.dirichlet.shape[0]:
            r = r.clone()
            r[self.dirichlet] = 0
        return r

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        r = self.apply_ct(self.cell_apply_raw(self.apply_c(u)))
        if self.constrained.shape[0]:
            r[self.constrained] = u[self.constrained]
        return r

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Plain dot: every DoF appears once in the global layout."""
        return torch.sum(x * y)


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------

def split_boundary_constraints(
    dofh: DoFHandler, hanging: Constraints
) -> tuple[Constraints, np.ndarray]:
    """Dirichlet takes priority over hanging rows (the reference calls
    interpolate_boundary_values before make_hanging_node_constraints —
    multigrid_throughput.cc:2305-2312): boundary slaves become Dirichlet."""
    on_boundary = dofh.boundary_mask[hanging.slave]
    keep = ~on_boundary
    hang = Constraints(
        hanging.n_dofs,
        hanging.slave[keep],
        hanging.masters[keep],
        hanging.weights[keep],
    )
    dirichlet = np.nonzero(dofh.boundary_mask)[0].astype(np.int32)
    return hang, dirichlet


def make_operator(
    dofh: DoFHandler,
    hanging: Constraints,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> LaplaceOperator:
    """The gather-engine operator of one DoFHandler on ``device``."""
    mesh = dofh.mesh
    dim, p = dofh.dim, dofh.degree
    hang, dirichlet = split_boundary_constraints(dofh, hanging)
    scale = mesh.h(mesh.level).astype(np.float64) ** (dim - 2)
    constrained = np.unique(np.concatenate([dirichlet, hang.slave]))
    K = max(hang.masters.shape[1], 1)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def val(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    masters = hang.masters if hang.masters.size else np.zeros((0, K), np.int64)
    return LaplaceOperator(
        cell_dofs=idx(dofh.cell_dofs),
        cell_sum=FixedOrderSum.build(dofh.cell_dofs, dofh.n_dofs, device),
        scale=val(scale),
        elem=val(element.laplace_element_matrix(dim, p)),
        hanging=ConstraintTable(
            idx(hang.slave),
            idx(masters),
            val(hang.weights if hang.weights.size else np.zeros((0, K))),
            # padding entries (weight 0) take no part in the sums
            FixedOrderSum.build(
                np.where(hang.weights != 0, masters, -1) if hang.weights.size else masters,
                dofh.n_dofs, device,
            ),
        ),
        dirichlet=idx(dirichlet),
        constrained=idx(constrained),
        n_dofs=dofh.n_dofs,
    )


def compute_diagonal(
    dofh: DoFHandler,
    hanging: Constraints,
    dtype=np.float64,
    cell_weights: np.ndarray | None = None,
) -> np.ndarray:
    """Exact diagonal of C^T A C with 1.0 on constrained rows (host-side).

    Mirrors MatrixFreeTools::compute_diagonal + safe inversion semantics
    (reference: include/operator.h:228-242).  Vectorised: unconstrained cells
    contribute scale * diag(elem) directly; for cells containing hanging
    slaves, per-(cell, global-target) weight vectors w are accumulated and the
    quadratic form w^T A_ref w evaluated as one batched GEMM.
    """
    mesh, dim, p = dofh.mesh, dofh.dim, dofh.degree
    hang, dirichlet = split_boundary_constraints(dofh, hanging)
    elem = element.laplace_element_matrix(dim, p)
    nloc = dofh.n_loc
    scale = mesh.h(mesh.level).astype(np.float64) ** (dim - 2)
    if cell_weights is not None:
        scale = scale * np.asarray(cell_weights, np.float64)

    # int32 throughout the volume-sized stages: on this host NEW memory costs
    # ~9 s/GB in host-backed page faults, so halving the index temporaries is
    # a direct setup-time win (DESIGN.md)
    slave_row = np.full(dofh.n_dofs, -1, dtype=np.int32)
    slave_row[hang.slave] = np.arange(len(hang.slave), dtype=np.int32)

    cd = dofh.cell_dofs  # int32 [n_cells, nloc]
    has_slave = (slave_row[cd] >= 0).any(axis=1)

    # unconstrained cells: diagonal of scale * elem (bincount is ~10x add.at);
    # constrained cells enter with weight 0 here (handled exactly below),
    # avoiding a volume-sized copy of the unconstrained cell_dofs
    d = np.bincount(
        cd.reshape(-1),
        weights=(
            np.where(has_slave, 0.0, scale)[:, None] * np.diag(elem)[None, :]
        ).reshape(-1),
        minlength=dofh.n_dofs,
    )

    # constrained cells: exact quadratic forms.  Build the sparse
    # (cell, target, local, weight) entries DIRECTLY — the dense
    # [ncc, nloc, K+1] staging tensors are ~95% explicit zeros (only slave
    # nodes carry master couplings) and cost gigabytes at scale.
    cc_idx = np.nonzero(has_slave)[0]
    if len(cc_idx):
        K = hang.masters.shape[1]
        ccd = cd[cc_idx]                                  # [ncc, nloc]
        rows = slave_row[ccd]                             # [ncc, nloc]
        is_s = rows >= 0
        # own-basis entries: non-slave nodes target their own dof, weight 1
        own_c, own_l = np.nonzero(~is_s)
        # master couplings: slave nodes target their masters
        sl_c, sl_l = np.nonzero(is_s)
        sr = rows[sl_c, sl_l]                             # slave row per entry
        mW = hang.weights[sr]                             # [ns, K]
        mT = hang.masters[sr]                             # [ns, K]
        mnz = mW != 0.0
        e_c, e_k = np.nonzero(mnz)
        cidx = np.concatenate([own_c, sl_c[e_c]])
        tgt = np.concatenate([ccd[own_c, own_l], mT[e_c, e_k]]).astype(np.int64)
        lidx = np.concatenate([own_l, sl_l[e_c]])
        val = np.concatenate([np.ones(len(own_c)), mW[e_c, e_k]])
        key = cidx * np.int64(dofh.n_dofs) + tgt
        from ..mesh.native import unique_inverse

        ufirst, grp = unique_inverse(key)
        ukey = key[ufirst]
        gcell = (ukey // dofh.n_dofs).astype(np.int64)
        gtgt = (ukey % dofh.n_dofs).astype(np.int64)
        counts = np.bincount(grp, minlength=len(ukey))
        # fast path: most (cell, target) groups hold a single basis entry
        # w = v * e_l, whose quadratic form is v^2 * elem[l, l]
        single = counts == 1
        single_grp = single[grp]
        sg = grp[single_grp]
        d += np.bincount(
            gtgt[sg],
            weights=val[single_grp] ** 2
            * np.diag(elem)[lidx[single_grp]]
            * scale[cc_idx][gcell[sg]],
            minlength=dofh.n_dofs,
        )
        # general rows (true master couplings): batched quadratic form.
        # Weight patterns repeat massively across cells (the same relative
        # face configurations recur), so dedupe W rows by a position-mixed
        # ~122-bit content hash and run the dense GEMM only on the unique
        # patterns (~10^2-10^3 instead of ~10^5-10^6 rows at scale).  The
        # grouping is spot-checked exactly below: one reconstructed
        # non-representative row per collision bucket must match its
        # representative's dense row.
        multi = np.nonzero(~single)[0]
        if len(multi):
            remap = np.full(len(ukey), -1, np.int64)
            remap[multi] = np.arange(len(multi))
            mg = remap[grp]
            msel = mg >= 0
            eg = mg[msel]                 # multi-group id per entry
            el = lidx[msel]
            ev = val[msel]

            # order-independent ~122-bit per-group content hash: the quad
            # form is a function of the (local node, weight) multiset only,
            # and those multisets repeat massively across cells (the same
            # relative hanging-face configurations).  Per-entry splitmix of
            # (weight bits, node), summed per group via two exact float64
            # bincounts per 64-bit lane (halves < 2^32, group sums < 2^53).
            def mix(bits, salt):
                m = (bits ^ np.uint64(salt)) * np.uint64(0x9E3779B97F4A7C15)
                m ^= m >> np.uint64(29)
                m *= np.uint64(0xBF58476D1CE4E5B9)
                m ^= m >> np.uint64(32)
                return m

            vb = ev.view(np.uint64) + (el.astype(np.uint64) << np.uint64(1))
            G = len(multi)

            def ghash(salt):
                m = mix(vb, salt)
                lo = np.bincount(
                    eg, weights=(m & np.uint64(0xFFFFFFFF)).astype(np.float64),
                    minlength=G,
                ).astype(np.uint64)
                hi = np.bincount(
                    eg, weights=(m >> np.uint64(32)).astype(np.float64),
                    minlength=G,
                ).astype(np.uint64)
                return (hi << np.uint64(32)) + lo

            h1, h2 = ghash(0x243F6A8885A308D3), ghash(0x13198A2E03707344)
            from ..mesh.native import unique_inverse as _uinv

            u1f, u1 = _uinv((h1 >> np.uint64(1)).view(np.int64))
            key2 = (np.asarray(u1, np.uint64) << np.uint64(33)) ^ (
                h2 >> np.uint64(31)
            )
            huf, hinv = _uinv((key2 >> np.uint64(1)).view(np.int64))

            # dense weight vectors ONLY for the representative groups;
            # rep_id[huf] enumerates uniques in hinv's id order, so
            # qu[hinv] maps each group to its pattern's quadratic form
            is_rep = np.zeros(G, bool)
            is_rep[huf] = True
            rep_id = np.full(G, -1, np.int64)
            rep_id[huf] = np.arange(len(huf))
            esel = is_rep[eg]
            Wu = np.zeros((len(huf), nloc))
            np.add.at(Wu, (rep_id[eg[esel]], el[esel]), ev[esel])
            # exact spot-check of the hash grouping: reconstruct ONE
            # non-representative member per bucket and require its dense row
            # to match the representative's (rep rows are Wu[bucket] since
            # rep_id[huf[b]] == b).  Cost: one extra scatter over the
            # non-rep entries; a collision would raise here.
            nonrep = np.nonzero(~is_rep)[0]
            if len(nonrep):
                firstnr = np.full(len(huf), -1, np.int64)
                firstnr[hinv[nonrep][::-1]] = nonrep[::-1]
                chk = firstnr[firstnr >= 0]
                mask2 = np.zeros(G, bool)
                mask2[chk] = True
                id2 = np.full(G, -1, np.int64)
                id2[chk] = np.arange(len(chk))
                sel2 = mask2[eg]
                W2 = np.zeros((len(chk), nloc))
                np.add.at(W2, (id2[eg[sel2]], el[sel2]), ev[sel2])
                if not np.allclose(W2, Wu[hinv[chk]], rtol=1e-12, atol=0.0):
                    raise RuntimeError(
                        "hanging-weight hash-dedup collision detected in "
                        "compute_diagonal (distinct weight patterns grouped "
                        "together) — report with the mesh/degree"
                    )
            qu = ((Wu @ elem) * Wu).sum(axis=1)
            quad = qu[hinv] * scale[cc_idx][gcell[multi]]
            d += np.bincount(gtgt[multi], weights=quad, minlength=dofh.n_dofs)

    constrained = np.unique(np.concatenate([dirichlet, hang.slave]))
    d[constrained] = 1.0
    d[d == 0.0] = 1.0
    return d.astype(dtype)
