"""Host-side constraint helpers of the Laplace operator.

The port keeps only the two host functions the hybrid path needs:
``split_boundary_constraints`` (Dirichlet over hanging priority) and the
exact constrained diagonal ``compute_diagonal`` (reference:
include/operator.h:228-242).  The gather engine waits for its own slice.
"""

from __future__ import annotations

import numpy as np

from ..mesh.dof import Constraints, DoFHandler
from . import element


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
