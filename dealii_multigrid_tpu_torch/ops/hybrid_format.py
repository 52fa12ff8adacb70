"""Host half of the hybrid patch engine: the slot layout and the operator tables.

NumPy only.  The layout (patch lattices of aligned K^3 same-level cell
blocks plus a singleton bucket for the rest), the exchange classification by
exact integer simulation of the device sweeps, the structured hanging-face
tables and the per-node constraint tables are built here exactly as the JAX
package builds them (dealii_multigrid_tpu/ops/hybrid.py), so both packages
apply identical tables.  ``hybrid_operator_tables`` returns them as a plain
dict of NumPy arrays plus static metadata; ``ops.hybrid.HybridOperator``
moves them onto a torch device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.dof import Constraints, DoFHandler, local_node_indices
from ..mesh.octree import AdaptiveMesh, morton_encode
from . import element, tensor
from .operator import split_boundary_constraints


def _assembled_1d(mat: np.ndarray, K: int, degree: int) -> np.ndarray:
    """Assemble the 1D per-cell matrix into the K-cell patch matrix (S x S)."""
    S = K * degree + 1
    out = np.zeros((S, S))
    for k in range(K):
        out[k * degree : k * degree + degree + 1, k * degree : k * degree + degree + 1] += mat
    return out


@dataclass
class HybridFormat:
    """Host-side description of the hybrid slot layout for one level.

    The flat slot vector is the patch bucket ``[NP, S, S, S]`` followed by
    the singleton bucket ``[NS, nloc]`` (the reference's single-device
    layout; its device-major multi-device layout is not ported).
    """

    dofh: DoFHandler
    K: int
    S: int
    # patch bucket
    patch_level: np.ndarray      # [NP] (-1 for padding dummies)
    patch_block: np.ndarray      # [NP, 3] block anchor (units of K cells)
    patch_cells: np.ndarray      # [NP, K^3] global cell ids (block-local x-fastest)
    patch_dof: np.ndarray        # [NP, S, S, S] global dof (axes: x, y, z)
    nbr: np.ndarray              # [6, NP] same-level face neighbour patch (or -1)
    # singleton bucket
    single_cells: np.ndarray     # [NS] (-1 for padding dummies)
    # slots
    slot_dof: np.ndarray         # [n_slots] (sentinel n_dofs on dummy slots)
    rep_slot: np.ndarray         # [n_dofs]
    owner: np.ndarray            # [n_slots] 1.0 on exactly one slot per dof
    nbr_s: np.ndarray            # [6, NS] singleton face-neighbour singleton (or -1)
    use_singleton_sweeps: bool
    # irregular exchange groups (dofs not covered by the structured sweeps)
    irr_slots: np.ndarray        # [G, Kg] slot ids (pad: n_slots)
    irr_out_slots: np.ndarray    # [W] slots to overwrite
    irr_out_group: np.ndarray    # [W] group index per overwrite target
    # patch<->singleton conforming interfaces, per (geometric axis g, patch
    # face side): entry 2g+side_p is None or (pidx, b1, b2, sidx) — the
    # singleton sidx's (g, 1-side_p) face coincides with the n1 x n1 subblock
    # of patch pidx's (g, side_p) face plane at block coords (b1, b2)
    cross_faces: tuple = ()
    use_cross: bool = False

    @property
    def n_patches(self) -> int:
        return len(self.patch_level)

    @property
    def n_singles(self) -> int:
        return len(self.single_cells)

    @property
    def n_slots(self) -> int:
        return len(self.slot_dof)

    @property
    def patch_slots(self) -> int:
        return self.n_patches * self.S**3

    def patch_slot_base(self, i):
        """First flat slot of patch i (vectorised)."""
        return i * self.S**3

    def single_slot_base(self, j):
        """First flat slot of singleton j (vectorised)."""
        return self.patch_slots + j * self.dofh.n_loc

    def from_global(self, u: np.ndarray) -> np.ndarray:
        u = np.asarray(u)
        # dummy slots carry the sentinel dof id n_dofs -> read exact zero
        return np.concatenate([u, np.zeros(1, u.dtype)])[self.slot_dof]

    def to_global(self, flat: np.ndarray) -> np.ndarray:
        return flat[self.rep_slot]


def _find_patches(mesh: AdaptiveMesh, K: int):
    """Complete aligned K^3 same-level blocks; returns (level, block, cells
    [NP, K^3] x-fastest block-local order, covered_mask)."""
    k2 = K.bit_length() - 1
    assert 1 << k2 == K
    covered = np.zeros(mesh.n_cells, dtype=bool)
    p_level, p_block, p_cells = [], [], []
    for l in np.unique(mesh.level):
        if l < k2:
            continue
        sel = np.nonzero(mesh.level == l)[0]
        block = mesh.anchor[sel] >> k2
        local = mesh.anchor[sel] & (K - 1)
        lflat = local[:, 0] + K * local[:, 1] + K * K * local[:, 2]
        bcode = morton_encode(block)
        order = np.lexsort((lflat, bcode))
        sel, bcode, lflat, block = sel[order], bcode[order], lflat[order], block[order]
        # group boundaries
        uniq, start, counts = np.unique(bcode, return_index=True, return_counts=True)
        complete = counts == K**3
        starts = start[complete]
        if len(starts) == 0:
            continue
        gather = starts[:, None] + np.arange(K**3)[None, :]
        # within a complete group, entries are sorted by lflat = 0..K^3-1
        cells = sel[gather]
        p_level.append(np.full(len(starts), l, np.int32))
        p_block.append(block[starts])
        p_cells.append(cells)
        covered[cells.reshape(-1)] = True
    if p_level:
        return (
            np.concatenate(p_level),
            np.concatenate(p_block),
            np.concatenate(p_cells),
            covered,
        )
    return (
        np.zeros(0, np.int32),
        np.zeros((0, 3), np.int64),
        np.zeros((0, K**3), np.int64),
        covered,
    )


# the singleton bucket reshapes x-fastest flat data to [cell, z, y, x]:
# sweep axes 1/2/3 = z/y/x need neighbour rows (4,5)/(2,3)/(0,1)
SINGLE_SWEEP_ROWS = np.asarray([4, 5, 2, 3, 0, 1])


def _neighbour_lookup(lvl: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """[6, n] same-level face-neighbour indices (-1 = none) for items at
    integer ``coords`` [n, 3] on level ``lvl`` [n], via packed-key
    searchsorted.  Replaces the per-item Python dict loops in
    build_hybrid_format (seconds at r>=7 singleton counts on the one-core
    host)."""
    n = len(lvl)
    if n == 0:
        return np.full((6, 0), -1, np.int64)
    lvl = np.asarray(lvl, np.int64)
    c = np.asarray(coords, np.int64) + 1  # bias: the -1 face offset stays >= 0
    b = int(int(c.max()) + 2).bit_length()
    lb = int(int(lvl.max()) + 1).bit_length()
    assert 3 * b + lb <= 62, "packed neighbour key overflow"

    def pack(cc):
        return (
            (lvl << (3 * b)) | (cc[:, 0] << (2 * b)) | (cc[:, 1] << b)
            | cc[:, 2]
        )

    key = pack(c)
    from ..mesh.native import argsort_i64

    order = argsort_i64(key)
    skey = key[order]
    out = np.full((6, n), -1, np.int64)
    for d in range(3):
        for side in (0, 1):
            q = c.copy()
            q[:, d] += 1 if side else -1
            qkey = pack(q)
            pos = np.searchsorted(skey, qkey)
            posc = np.minimum(pos, n - 1)
            hit = skey[posc] == qkey
            out[2 * d + side] = np.where(hit, order[posc], -1)
    return out


def _simulate_sweeps(raw: np.ndarray, nbr: np.ndarray, S: int) -> np.ndarray:
    """Exact host mirror of the device exchange sweeps (integer arithmetic).
    Works for any same-size block bucket (K^3 patches or single cells)."""
    up = raw.copy()
    NP = up.shape[0]
    for d in range(3):
        axis = d + 1
        lo_n, hi_n = nbr[2 * d], nbr[2 * d + 1]

        def plane(arr, idx, pos):
            sl = [slice(None)] * 4
            sl[axis] = pos
            src = arr[np.maximum(idx, 0)][tuple([slice(None)] + sl[1:])]
            src = src * (idx >= 0).reshape((-1,) + (1,) * (src.ndim - 1))
            return src

        add_lo = plane(up, lo_n, S - 1)   # neighbour-below's top plane
        add_hi = plane(up, hi_n, 0)       # neighbour-above's bottom plane
        sl0 = [slice(None)] * 4
        sl0[axis] = 0
        slS = [slice(None)] * 4
        slS[axis] = S - 1
        up[tuple(sl0)] += add_lo
        up[tuple(slS)] += add_hi
    return up


def _build_cross_tables(mesh, p_cells, single_cells, K: int):
    """Patch<->singleton conforming-interface tables (see HybridFormat).

    Every singleton whose same-level face neighbour is patch-covered meets
    that patch on an n1 x n1 subblock of the patch's boundary face plane (a
    complete K^3 block has no interior cell exposed), so the interface is a
    dense block grid — the input to the structured cross exchange."""
    NP = p_cells.shape[0] if p_cells.ndim == 2 else 0
    NS = len(single_cells)
    out = [None] * 6
    if not (NP and NS):
        return tuple(out)
    n_cells = mesh.n_cells
    parr = np.full(n_cells, -1, np.int64)
    lloc3 = np.zeros((n_cells, 3), np.int16)
    flat = p_cells.reshape(-1)
    parr[flat] = np.repeat(np.arange(NP, dtype=np.int64), K**3)
    f = np.tile(np.arange(K**3, dtype=np.int64), NP)
    lloc3[flat, 0] = f % K
    lloc3[flat, 1] = (f // K) % K
    lloc3[flat, 2] = f // (K * K)
    find = _active_lookup_cache(mesh)
    A = mesh.anchor[single_cells]
    L = mesh.level[single_cells]
    acc = [[] for _ in range(6)]
    for l in np.unique(L):
        jsel = np.nonzero(L == l)[0]
        lim = 1 << int(l)
        for g in range(3):
            for sside in (0, 1):
                na = A[jsel].copy()
                na[:, g] += 1 if sside else -1
                ok = (na[:, g] >= 0) & (na[:, g] < lim)
                if not ok.any():
                    continue
                js, naq = jsel[ok], na[ok]
                cand = find(l, naq)
                hit = (
                    (mesh.level[cand] == l)
                    & (mesh.anchor[cand] == naq).all(axis=1)
                    & (parr[cand] >= 0)
                )
                if not hit.any():
                    continue
                cand, js = cand[hit], js[hit]
                side_p = 1 - sside
                oth = [e for e in range(3) if e != g]
                acc[2 * g + side_p].append(
                    (
                        parr[cand],
                        lloc3[cand, oth[0]].astype(np.int64),
                        lloc3[cand, oth[1]].astype(np.int64),
                        js.astype(np.int64),
                    )
                )
    for k in range(6):
        if acc[k]:
            out[k] = tuple(np.concatenate(cols) for cols in zip(*acc[k]))
    return tuple(out)


def _sim_sub_assemble(sp, pidx, b1, b2, NP, K, n1, p):
    """[m, n1, n1] singleton planes -> dense [NP, S, S] overlap-added patch
    face contribution (integer-exact host mirror of the device E-GEMMs)."""
    S = K * p + 1
    grid = np.zeros((NP, K, K, n1, n1), dtype=sp.dtype)
    grid[pidx, b1, b2] = sp
    Z = np.zeros((NP, S, S), dtype=sp.dtype)
    for i in range(n1):
        for j in range(n1):
            Z[:, i : i + (K - 1) * p + 1 : p, j : j + (K - 1) * p + 1 : p] += grid[
                :, :, :, i, j
            ]
    return Z


def _sim_sub_extract(ppre, pidx, b1, b2, n1, p):
    """[m, n1, n1] subblocks of patch face planes at block coords (b1, b2)."""
    ii = np.arange(n1)
    return ppre[
        pidx[:, None, None],
        b1[:, None, None] * p + ii[None, :, None],
        b2[:, None, None] * p + ii[None, None, :],
    ]


def _simulate_full(raw_p, raw_s, nbr, nbr_s, cross, S, n1, K, use_ssweep):
    """Exact host mirror of the INTERLEAVED device exchange (patch sweeps +
    singleton sweeps + patch<->singleton cross terms, one geometric axis at a
    time, all adds within an axis reading pre-axis values)."""
    up = raw_p.copy()
    us = raw_s.copy()
    NP = up.shape[0]
    p = n1 - 1

    def bplane(arr, idx, sl):
        src = arr[np.maximum(idx, 0)][(slice(None),) + sl[1:]]
        return src * (idx >= 0).reshape((-1,) + (1,) * (src.ndim - 1))

    for g in range(3):
        sax = 3 - g
        psl_lo = _face_slicer(S, g, 0)
        psl_hi = _face_slicer(S, g, 1)
        ssl_lo = [slice(None)] * 4
        ssl_lo[sax] = 0
        ssl_hi = [slice(None)] * 4
        ssl_hi[sax] = n1 - 1
        ssl_lo, ssl_hi = tuple(ssl_lo), tuple(ssl_hi)
        p_lo, p_hi = up[psl_lo], up[psl_hi]
        s_lo, s_hi = us[ssl_lo], us[ssl_hi]
        add_plo = bplane(up, nbr[2 * g], psl_hi)
        add_phi = bplane(up, nbr[2 * g + 1], psl_lo)
        if use_ssweep:
            add_slo = bplane(us, nbr_s[2 * g], ssl_hi)
            add_shi = bplane(us, nbr_s[2 * g + 1], ssl_lo)
        else:
            add_slo = np.zeros_like(s_lo)
            add_shi = np.zeros_like(s_hi)
        for side_p, ppre, spre in ((0, p_lo, s_hi), (1, p_hi, s_lo)):
            tbl = cross[2 * g + side_p]
            if tbl is None:
                continue
            pidx, b1, b2, sidx = tbl
            sp = spre[sidx].transpose(0, 2, 1)
            Z = _sim_sub_assemble(sp, pidx, b1, b2, NP, K, n1, p)
            sub = _sim_sub_extract(ppre, pidx, b1, b2, n1, p).transpose(0, 2, 1)
            if side_p == 0:
                add_plo = add_plo + Z
                np.add.at(add_shi, sidx, sub)
            else:
                add_phi = add_phi + Z
                np.add.at(add_slo, sidx, sub)
        up[psl_lo] += add_plo
        up[psl_hi] += add_phi
        us[ssl_lo] += add_slo
        us[ssl_hi] += add_shi
    return up, us


def build_hybrid_format(
    dofh: DoFHandler, K: int = 8, min_patches: int = 2
) -> HybridFormat:
    """Build the hybrid layout for one level. 3D only."""
    mesh = dofh.mesh
    assert mesh.dim == 3, "hybrid engine is 3D (2D uses the base engine)"
    p = dofh.degree
    while True:
        p_level, p_block, p_cells, covered = _find_patches(mesh, K)
        if len(p_level) >= min_patches or K == 1:
            break
        K //= 2
    if K == 1:  # no useful patches: singleton-only layout
        covered = np.zeros(mesh.n_cells, dtype=bool)
        p_level = np.zeros(0, np.int32)
        p_block = np.zeros((0, 3), np.int64)
        p_cells = np.zeros((0, 1), np.int64)
    S = K * p + 1
    NP = len(p_level)
    single_cells = np.nonzero(~covered)[0]
    NS = len(single_cells)
    nloc = dofh.n_loc

    # patch_dof lattice: cell at block-local (bx,by,bz), node (i,j,k) ->
    # lattice (bx*p+i, by*p+j, bz*p+k)
    loc = local_node_indices(3, p)                       # [nloc, 3] x fastest
    bidx = np.empty((K**3, 3), dtype=np.int64)
    f = np.arange(K**3)
    for d in range(3):
        bidx[:, d] = (f // K**d) % K
    TX = (bidx[:, None, 0] * p + loc[None, :, 0]).reshape(-1)
    TY = (bidx[:, None, 1] * p + loc[None, :, 1]).reshape(-1)
    TZ = (bidx[:, None, 2] * p + loc[None, :, 2]).reshape(-1)
    patch_dof = np.zeros((NP, S, S, S), dtype=np.int32)
    if NP:
        vals = dofh.cell_dofs[p_cells].reshape(NP, -1)   # [NP, K^3*nloc]
        patch_dof[:, TX, TY, TZ] = vals

    # neighbours (vectorized packed-key lookup; same dict semantics)
    nbr = (
        _neighbour_lookup(p_level, p_block)
        if NP
        else np.full((6, 0), -1, dtype=np.int64)
    )

    # slots — every dof id 0..n_dofs-1 occurs, so unique_inverse's group ids
    # ARE the dof ids and its stable ``first`` is each dof's minimal slot
    # (exactly the old argsort-based reduction, one native radix instead)
    slot_dof = np.concatenate(
        [patch_dof.reshape(-1), dofh.cell_dofs[single_cells].reshape(-1)]
    )
    n_slots = len(slot_dof)
    from ..mesh.native import unique_inverse as _uinv

    rep_slot, _inv = _uinv(slot_dof)
    assert len(rep_slot) == dofh.n_dofs
    rep_slot = rep_slot.astype(np.int64)
    owner = np.zeros(n_slots, np.float32)
    owner[rep_slot] = 1.0

    # singleton-singleton face neighbours (their own sweep bucket)
    nbr_s = (
        _neighbour_lookup(mesh.level[single_cells], mesh.anchor[single_cells])
        if NS
        else np.full((6, 0), -1, dtype=np.int64)
    )

    # regular/irregular classification by exact simulation.  Values stay
    # < 2^40 and per-dof slot multiplicities are small, so sums stay < 2^53
    # and np.bincount's float64 accumulation is EXACT (np.add.at /
    # np.logical_and.at are per-element C loops — measured seconds at 33M
    # slots on the one-core host).
    rng = np.random.default_rng(12345)
    raw = rng.integers(1, 1 << 40, size=n_slots).astype(np.int64)
    group_sum = np.bincount(
        slot_dof, weights=raw.astype(np.float64), minlength=dofh.n_dofs
    ).astype(np.int64)
    swept = raw.copy()
    if NP:
        up = _simulate_sweeps(raw[: NP * S**3].reshape(NP, S, S, S), nbr, S)
        swept[: NP * S**3] = up.reshape(-1)

    def classify(swept_arr):
        bad = swept_arr != group_sum[slot_dof]
        reg = np.ones(dofh.n_dofs, dtype=bool)
        reg[slot_dof[bad]] = False
        return reg

    reg_without = classify(swept)
    use_singleton_sweeps = False
    dof_regular = reg_without
    if NS:
        n1 = p + 1
        swept2 = swept.copy()
        # the singleton flat order is x-fastest, so the [NS, n1, n1, n1]
        # reshape has axes [cell, z, y, x]: sweep axis 1 must use the
        # z-neighbour rows (the patch lattice is built x-major instead)
        us = _simulate_sweeps(
            raw[NP * S**3 :].reshape(NS, n1, n1, n1),
            nbr_s[SINGLE_SWEEP_ROWS],
            n1,
        )
        swept2[NP * S**3 :] = us.reshape(-1)
        reg_with = classify(swept2)
        # enable only when the saved irregular work clearly exceeds the cost
        # of the extra six plane sweeps over the singleton bucket
        saved = int(reg_with.sum() - reg_without.sum())
        if saved * 4 > 10 * NS:
            use_singleton_sweeps = True
            dof_regular = reg_with
    # patch<->singleton cross exchange: resolves the conforming interface
    # dofs between the two buckets (the dominant irregular population at mid
    # levels) with dense per-face assembly GEMMs instead of element scatters
    use_cross = False
    cross_faces = (None,) * 6
    if NP and NS:
        cross_faces = _build_cross_tables(mesh, p_cells, single_cells, K)
        m_total = sum(len(t[0]) for t in cross_faces if t is not None)
        if m_total:
            n1 = p + 1
            up_c, us_c = _simulate_full(
                raw[: NP * S**3].reshape(NP, S, S, S),
                raw[NP * S**3 :].reshape(NS, n1, n1, n1),
                nbr,
                nbr_s,
                cross_faces,
                S,
                n1,
                K,
                True,
            )
            swept3 = raw.copy()
            swept3[: NP * S**3] = up_c.reshape(-1)
            swept3[NP * S**3 :] = us_c.reshape(-1)
            reg_c = classify(swept3)
            saved_c = int(reg_c.sum() - dof_regular.sum())
            # the cross machinery is ~4 block-row ops per interface pair;
            # each saved dof removes ~2-3 element-priced irregular slots
            if saved_c * 4 > 3 * m_total:
                use_cross = True
                use_singleton_sweeps = True
                dof_regular = reg_c
        if not use_cross:
            cross_faces = (None,) * 6
    irr_dofs = np.nonzero(~dof_regular)[0]

    # irregular groups: all slots of each irregular dof
    if len(irr_dofs):
        is_irr = np.zeros(dofh.n_dofs, dtype=bool)
        is_irr[irr_dofs] = True
        sel = is_irr[slot_dof]
        s_ids = np.nonzero(sel)[0]
        s_dofs = slot_dof[s_ids]
        o = np.argsort(s_dofs, kind="stable")
        s_ids, s_dofs = s_ids[o], s_dofs[o]
        uniq, start, counts = np.unique(s_dofs, return_index=True, return_counts=True)
        G = len(uniq)
        Kg = int(counts.max())
        irr_slots = np.full((G, Kg), n_slots, dtype=np.int64)  # pad slot
        for k in range(Kg):
            has = counts > k
            irr_slots[has, k] = s_ids[start[has] + k]
        irr_out_slots = s_ids
        irr_out_group = np.repeat(np.arange(G), counts)
    else:
        irr_slots = np.zeros((0, 1), np.int64)
        irr_out_slots = np.zeros(0, np.int64)
        irr_out_group = np.zeros(0, np.int64)

    return HybridFormat(
        dofh=dofh,
        K=K,
        S=S,
        patch_level=p_level,
        patch_block=p_block,
        patch_cells=p_cells,
        patch_dof=patch_dof,
        nbr=nbr,
        nbr_s=nbr_s,
        use_singleton_sweeps=use_singleton_sweeps,
        single_cells=single_cells,
        slot_dof=slot_dof,
        rep_slot=rep_slot,
        owner=owner,
        irr_slots=irr_slots,
        irr_out_slots=irr_out_slots,
        irr_out_group=irr_out_group,
        cross_faces=cross_faces,
        use_cross=use_cross,
    )


def slots_of(fmt: HybridFormat, dofs: np.ndarray):
    """All slots of each dof: (padded [n, Km] with pad=n_slots, flat list,
    group index per flat entry)."""
    cached = getattr(fmt, "_slot_order_cache", None)
    if cached is None:
        from ..mesh.native import argsort_i64

        order = argsort_i64(fmt.slot_dof)
        cached = (order, fmt.slot_dof[order])
        fmt._slot_order_cache = cached
    order, sd = cached
    starts = np.searchsorted(sd, dofs)
    ends = np.searchsorted(sd, dofs, side="right")
    counts = ends - starts
    Km = int(counts.max()) if len(counts) else 1
    padded = np.full((len(dofs), max(Km, 1)), fmt.n_slots, dtype=np.int64)
    for k in range(Km):
        has = counts > k
        padded[has, k] = order[starts[has] + k]
    if len(dofs):
        total = int(counts.sum())
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        flat = order[np.repeat(starts, counts) + within]
    else:
        flat = np.zeros(0, np.int64)
    grp = np.repeat(np.arange(len(dofs)), counts)
    return padded, flat, grp


def cell_slot_table(fmt: HybridFormat) -> np.ndarray:
    """[n_cells, nloc] slot id of each cell-local node in the hybrid layout."""
    dofh = fmt.dofh
    p = dofh.degree
    nloc = dofh.n_loc
    out = np.full((dofh.mesh.n_cells, nloc), -1, dtype=np.int64)
    if fmt.n_patches:
        loc = local_node_indices(3, p)
        K = fmt.K
        S = fmt.S
        bidx = np.empty((K**3, 3), dtype=np.int64)
        f = np.arange(K**3)
        for d in range(3):
            bidx[:, d] = (f // K**d) % K
        # lattice flat index (x, y, z axes of the [NP, S, S, S] array)
        TX = bidx[:, None, 0] * p + loc[None, :, 0]
        TY = bidx[:, None, 1] * p + loc[None, :, 1]
        TZ = bidx[:, None, 2] * p + loc[None, :, 2]
        lat = (TX * S + TY) * S + TZ                     # [K^3, nloc]
        real = np.nonzero(fmt.patch_level >= 0)[0]
        base = fmt.patch_slot_base(real)[:, None, None]
        slots = base + lat[None, :, :]
        out[fmt.patch_cells[real].reshape(-1)] = slots.reshape(-1, nloc)
    if fmt.n_singles:
        real = np.nonzero(fmt.single_cells >= 0)[0]
        base = fmt.single_slot_base(real)[:, None]
        out[fmt.single_cells[real]] = base + np.arange(nloc)[None, :]
    return out


def find_structured_faces(fmt: HybridFormat, hang_slave: np.ndarray):
    """Detect fine patch faces FULLY hanging on level-(l-1) cells.

    The coarse source is a sub x sub node plane addressed through a slot
    table (works whether the coarse cells sit in patches or singletons).
    Returns (buckets, covered_slots): buckets = list of
    (fine_level, d, side, fidx [n], src_slots [n, sub, sub]).
    """
    mesh = fmt.dofh.mesh
    p = fmt.dofh.degree
    K, S = fmt.K, fmt.S
    covered = np.zeros(fmt.n_slots, bool)
    if fmt.n_patches == 0 or K < 2:
        return [], covered
    half = K // 2
    sub = half * p + 1
    cslot = cell_slot_table(fmt)
    loc = local_node_indices(3, p)
    # same-level patch lookup (conforming neighbour => not hanging)
    key = {}
    for i in range(fmt.n_patches):
        if fmt.patch_level[i] < 0:  # padding dummy
            continue
        key[
            (int(fmt.patch_level[i]), int(fmt.patch_block[i, 0]),
             int(fmt.patch_block[i, 1]), int(fmt.patch_block[i, 2]))
        ] = i
    k2 = K.bit_length() - 1

    idx1 = np.arange(S)
    out = {}
    for i in range(fmt.n_patches):
        l = int(fmt.patch_level[i])
        if l < 0:  # padding dummy
            continue
        blk = fmt.patch_block[i]
        for d in range(3):
            t1, t2 = [e for e in range(3) if e != d]
            for side in (0, 1):
                nb = blk.copy()
                nb[d] += 1 if side else -1
                if nb[d] < 0 or nb[d] >= (1 << max(l - k2, 0)):
                    continue
                if (l, int(nb[0]), int(nb[1]), int(nb[2])) in key:
                    continue
                # the facing coarse region: half x half cells at level l-1
                base = np.zeros(3, np.int64)
                base[t1] = nb[t1] * half
                base[t2] = nb[t2] * half
                # facing coarse layer along d at level l-1: the layer of
                # coarse cells adjacent to the interface plane
                if side:  # fine patch's high face; coarse region above
                    base[d] = (nb[d] * K) >> 1
                else:     # coarse region below; its top layer
                    base[d] = ((blk[d] * K) >> 1) - 1

                # enumerate the half x half coarse cells on the facing layer
                cc = np.zeros((half, half, 3), np.int64)
                cc[..., d] = base[d]
                cc[..., t1] = base[t1] + np.arange(half)[:, None]
                cc[..., t2] = base[t2] + np.arange(half)[None, :]
                cells = mesh.covering_cell_level(l - 1, cc.reshape(-1, 3), l - 1)
                if (cells != l - 1).any():
                    continue  # not uniformly one level coarser
                find = _active_lookup_cache(mesh)
                cidx = find(l - 1, cc.reshape(-1, 3))
                # coarse face plane slot table [sub, sub]
                plane = np.full((sub, sub), -1, np.int64)
                # node on the coarse cell's face toward the fine patch:
                # local index on axis d = p if side==0 ... coarse cell is on
                # the OTHER side: its facing face has i_d = 0 if side else p
                i_d = 0 if side else p
                sel = loc[:, d] == i_d
                fl = loc[sel]
                for k, (c1, c2) in enumerate(
                    [(a, b) for a in range(half) for b in range(half)]
                ):
                    cell = cidx[c1 * half + c2]
                    ii = fl[:, t1] + c1 * p
                    jj = fl[:, t2] + c2 * p
                    plane[ii, jj] = cslot[cell][sel]
                assert (plane >= 0).all()
                bucket = out.setdefault((l, d, side), ([], []))
                bucket[0].append(i)
                bucket[1].append(plane)
                # mark fine face slots covered
                base_slot = int(fmt.patch_slot_base(i))
                if d == 0:
                    pl = (np.full((S, S), (S - 1) if side else 0) * S + idx1[:, None]) * S + idx1[None, :]
                elif d == 1:
                    pl = (idx1[:, None] * S + ((S - 1) if side else 0)) * S + idx1[None, :]
                else:
                    pl = (idx1[:, None] * S + idx1[None, :]) * S + ((S - 1) if side else 0)
                covered[base_slot + pl.reshape(-1)] = True
    buckets = [
        (l, d, side, np.asarray(f, np.int64), np.stack(s))
        for (l, d, side), (f, s) in sorted(out.items())
    ]
    return buckets, covered


def _single_face_slots(fmt: HybridFormat, j_arr: np.ndarray, d: int, side: int):
    """Flat slot ids of singleton j's face plane, axes (t_hi, t_lo) =
    the non-d geometric axes in descending order (the order produced by
    slicing the [cell, z, y, x] singleton lattice)."""
    p = fmt.dofh.degree
    n1 = p + 1
    pos = p if side else 0
    ij = np.arange(n1)
    if d == 0:    # plane [z, y]
        plane = pos + n1 * ij[None, :] + n1 * n1 * ij[:, None]
    elif d == 1:  # plane [z, x]
        plane = ij[None, :] + n1 * pos + n1 * n1 * ij[:, None]
    else:         # plane [y, x]
        plane = ij[None, :] + n1 * ij[:, None] + n1 * n1 * pos
    return fmt.single_slot_base(j_arr)[:, None, None] + plane[None]



def find_structured_single_faces(fmt: HybridFormat):
    """Detect singleton-cell faces FULLY hanging on a level-(l-1) cell.

    The hanging constraint on such a face is the 2D tensor interpolation of
    the parent-cell facing face with the half-embedding E_h[b] per in-plane
    axis (b = the fine cell's anchor parity) — two small GEMMs per bucket
    instead of per-node constraint rows (the singleton-side counterpart of
    find_structured_faces).  Returns (buckets, covered_slots) with buckets =
    list of (fine_level, d, side, pa, pb, sidx [n], src_slots [n, p+1, p+1]).
    """
    mesh = fmt.dofh.mesh
    p = fmt.dofh.degree
    n1 = p + 1
    covered = np.zeros(fmt.n_slots, bool)
    if fmt.n_singles == 0:
        return [], covered
    cslot = cell_slot_table(fmt)
    loc = local_node_indices(3, p)
    idx = mesh.active_index()

    def find_exact(level, anchors):
        got = idx.get(int(level))
        if got is None or len(got[0]) == 0:
            return np.full(len(anchors), -1, np.int64)
        codes_sorted, gidx = got
        q = morton_encode(anchors)
        pos = np.minimum(np.searchsorted(codes_sorted, q), len(codes_sorted) - 1)
        return np.where(codes_sorted[pos] == q, gidx[pos], -1)

    real = np.nonzero(fmt.single_cells >= 0)[0]
    cells = fmt.single_cells[real]
    levels = mesh.level[cells].astype(np.int64)
    anchors = mesh.anchor[cells]
    out = {}
    for d in range(3):
        t_hi, t_lo = [e for e in range(2, -1, -1) if e != d]
        for side in (0, 1):
            q = anchors.copy()
            q[:, d] += 1 if side else -1
            ext = 1 << levels
            inside = (q[:, d] >= 0) & (q[:, d] < ext)
            same = np.full(len(cells), -1, np.int64)
            for l in np.unique(levels):
                s = np.nonzero((levels == l) & inside)[0]
                if len(s):
                    same[s] = find_exact(l, q[s])
            cand = np.nonzero(inside & (same < 0))[0]
            if len(cand) == 0:
                continue
            par = np.full(len(cand), -1, np.int64)
            for l in np.unique(levels[cand]):
                s = np.nonzero(levels[cand] == l)[0]
                par[s] = find_exact(l - 1, q[cand[s]] >> 1)
            ok = np.nonzero(par >= 0)[0]
            if len(ok) == 0:
                continue
            sel = cand[ok]
            par_cells = par[ok]
            i_d = 0 if side else p
            fsel = loc[:, d] == i_d
            fl = loc[fsel]
            src = np.zeros((len(ok), n1, n1), np.int64)
            src[:, fl[:, t_hi], fl[:, t_lo]] = cslot[par_cells][:, fsel]
            assert (src >= 0).all()
            pa = (anchors[sel, t_hi] & 1).astype(np.int64)
            pb = (anchors[sel, t_lo] & 1).astype(np.int64)
            lv = levels[sel]
            for key in sorted(set(zip(lv.tolist(), pa.tolist(), pb.tolist()))):
                l, a, b_ = key
                m = (lv == l) & (pa == a) & (pb == b_)
                bucket = out.setdefault(
                    (int(l), d, side, int(a), int(b_)), ([], [])
                )
                bucket[0].extend(real[sel[m]].tolist())
                bucket[1].append(src[m])
            fs = _single_face_slots(fmt, real[sel], d, side)
            covered[fs.reshape(-1)] = True
    buckets = [
        (
            l, d, side, a, b_, np.asarray(sidx, np.int64),
            np.concatenate(srcs),
        )
        for (l, d, side, a, b_), (sidx, srcs) in sorted(out.items())
    ]
    return buckets, covered


def _active_lookup_cache(mesh):
    # cache ON the mesh instance (an id()-keyed global dict would collide
    # when ids are recycled after garbage collection)
    find = getattr(mesh, "_mgtpu_active_lookup", None)
    if find is None:
        idx = mesh.active_index()

        def find(level, anchors):
            codes_sorted, gidx = idx[int(level)]
            q = morton_encode(anchors)
            pos = np.searchsorted(codes_sorted, q)
            return gidx[np.minimum(pos, len(codes_sorted) - 1)]

        mesh._mgtpu_active_lookup = find
    return find


def _face_slicer(S: int, d: int, side: int):
    """Static slicing tuple selecting a patch's face plane [n, S, S]."""
    sl = [slice(None)] * 4
    sl[d + 1] = (S - 1) if side else 0
    return tuple(sl)


def _scatter_rounds(order, reads, writes, disjoint_writes):
    """Group sf levels into scatter rounds that the exact slot tables prove
    chain-free: a level starts a new round when it READS a slot an earlier
    level of the round WROTE (or, for scatter-set, writes one)."""
    rounds: list[tuple[int, ...]] = []
    cur: list[int] = []
    cur_w = np.zeros(0, np.int64)
    for i in order:
        conflict = bool(cur) and (
            np.isin(reads[i], cur_w).any()
            or (disjoint_writes and np.isin(writes[i], cur_w).any())
        )
        if conflict:
            rounds.append(tuple(cur))
            cur, cur_w = [], np.zeros(0, np.int64)
        cur.append(i)
        cur_w = np.concatenate([cur_w, writes[i]])
    if cur:
        rounds.append(tuple(cur))
    return tuple(rounds)


def hybrid_operator_tables(
    fmt: HybridFormat, hanging: Constraints
) -> tuple[dict, dict]:
    """Tables of the constrained Laplacian in the hybrid slot layout.

    Returns ``(tables, meta)``: ``tables`` maps the JAX HybridOperator's
    data-field names (plain path only) to NumPy arrays, float tables in
    float64 and index tables as integers, nested in tuples where the
    reference nests them; ``meta`` holds the static fields.  The same
    construction as dealii_multigrid_tpu.ops.hybrid.make_hybrid_operator
    without the TPU layout variants.
    """
    dofh = fmt.dofh
    mesh = dofh.mesh
    p = dofh.degree
    hang, dirichlet = split_boundary_constraints(dofh, hanging)

    KS = _assembled_1d(tensor.stiffness_matrix_1d(p), fmt.K, p)
    MS = _assembled_1d(tensor.mass_matrix_1d(p), fmt.K, p)
    elem_m = element.laplace_element_matrix(3, p)
    real_p = fmt.patch_level >= 0
    real_s = fmt.single_cells >= 0
    h_p = np.where(
        real_p, mesh.h(np.maximum(fmt.patch_level, 0)).astype(np.float64), 0.0
    )
    h_s = np.where(
        real_s,
        mesh.h(mesh.level[np.maximum(fmt.single_cells, 0)]).astype(np.float64),
        0.0,
    )

    # ---- structured hanging faces ----------------------------------------
    sf_raw, covered = find_structured_faces(fmt, hang.slave)
    ssf_raw, covered_s = find_structured_single_faces(fmt)
    covered = covered | covered_s
    # structured slaves: hanging slaves ALL of whose slots lie on covered faces
    if len(hang.slave):
        _, h_flat, h_grp = slots_of(fmt, hang.slave)
        cov_ok = np.ones(len(hang.slave), bool)
        np.logical_and.at(cov_ok, h_grp, covered[h_flat])
    else:
        cov_ok = np.zeros(0, bool)
    struct_sel = cov_ok
    table_sel = ~struct_sel
    # covered-face multiplicity per slot (for the C^T masks)
    S = fmt.S
    cov_count = np.zeros(fmt.n_slots, np.int64)
    slave_slot = np.zeros(fmt.n_slots, bool)
    if len(hang.slave):
        _, ssel_flat, _ = slots_of(fmt, hang.slave[struct_sel])
        slave_slot[ssel_flat] = True

    def face_slots(i_arr, d, side):
        idx = np.arange(S)
        if d == 0:
            plane = (np.full((S, S), (S - 1) if side else 0) * S + idx[:, None]) * S + idx[None, :]
        elif d == 1:
            plane = (idx[:, None] * S + ((S - 1) if side else 0)) * S + idx[None, :]
        else:
            plane = (idx[:, None] * S + idx[None, :]) * S + ((S - 1) if side else 0)
        return fmt.patch_slot_base(i_arr)[:, None, None] + plane[None, :, :]

    for l, d, side, fidx, src_slots in sf_raw:
        fs = face_slots(fidx, d, side)
        np.add.at(cov_count, fs.reshape(-1), slave_slot[fs.reshape(-1)].astype(np.int64))
    for l, d, side, pa, pb, sidx, src_slots in ssf_raw:
        fs = _single_face_slots(fmt, sidx, d, side)
        np.add.at(cov_count, fs.reshape(-1), slave_slot[fs.reshape(-1)].astype(np.int64))

    def ct_mask(fs):
        return np.where(
            slave_slot[fs] & (cov_count[fs] > 0),
            1.0 / np.maximum(cov_count[fs], 1),
            0.0,
        )

    # batch all structured faces of one fine level into single tables
    sf_levels = sorted({b[0] for b in sf_raw} | {b[0] for b in ssf_raw})
    sf_patch, sf_single = [], []
    sf_patch_rows, sf_patch_rows_meta = [], []
    lvl_face_np, lvl_src_np = [], []  # flat slot sets per level (rounds)
    for lev in sf_levels:
        faces, srcs, masks = [], [], []
        rows, rows_meta = [], []
        np_faces, np_srcs = [], []
        for l, d, side, fidx, src_slots in sf_raw:
            if l != lev:
                continue
            fs = face_slots(fidx, d, side)
            faces.append(fs)
            srcs.append(src_slots)
            masks.append(ct_mask(fs))
            rows.append(np.asarray(fidx, np.int64))
            rows_meta.append((d, side, len(fidx)))
            np_faces.append(fs.reshape(-1))
            np_srcs.append(np.asarray(src_slots).reshape(-1))
        sf_patch.append(
            (np.concatenate(faces), np.concatenate(srcs), np.concatenate(masks))
            if faces
            else None
        )
        sf_patch_rows.append(tuple(rows))
        sf_patch_rows_meta.append(tuple(rows_meta))
        faces, srcs, masks, pas, pbs = [], [], [], [], []
        for l, d, side, pa, pb, sidx, src_slots in ssf_raw:
            if l != lev:
                continue
            fs = _single_face_slots(fmt, sidx, d, side)
            faces.append(fs)
            srcs.append(src_slots)
            masks.append(ct_mask(fs))
            pas.append(np.full(len(sidx), pa, np.int64))
            pbs.append(np.full(len(sidx), pb, np.int64))
            np_faces.append(fs.reshape(-1))
            np_srcs.append(np.asarray(src_slots).reshape(-1))
        lvl_face_np.append(
            np.concatenate(np_faces) if np_faces else np.zeros(0, np.int64)
        )
        lvl_src_np.append(
            np.concatenate(np_srcs) if np_srcs else np.zeros(0, np.int64)
        )
        sf_single.append(
            (
                np.concatenate(faces),
                np.concatenate(srcs),
                np.concatenate(masks),
                np.concatenate(pas),
                np.concatenate(pbs),
            )
            if faces
            else None
        )
    # apply_c (ascending, scatter-set) flushes before a level that reads a
    # slot an earlier level wrote or writes one twice; ct_faces
    # (descending, scatter-add) only before a level reading a slot that a
    # finer level adds into
    sf_c_rounds = _scatter_rounds(
        range(len(sf_levels)), lvl_src_np, lvl_face_np, True
    )
    sf_ct_rounds = _scatter_rounds(
        range(len(sf_levels) - 1, -1, -1), lvl_face_np, lvl_src_np, False
    )
    sf_slave_keep = np.ones(fmt.n_slots, np.float32)
    sf_slave_keep[slave_slot] = 0.0

    Eh = tensor.h_embedding_1d(p)
    sub = (fmt.K // 2) * p + 1 if fmt.K >= 2 else 1
    E1 = np.zeros((S, sub))
    if fmt.K >= 2:
        for kf in range(fmt.K):
            kc, bb = kf >> 1, kf & 1
            E1[kf * p : kf * p + p + 1, kc * p : kc * p + p + 1] = Eh[bb]

    # per-node tables only for the remaining (non-structured) slaves; the
    # identity-on-constrained set keeps ALL slaves (structured included)
    full_slaves = hang.slave
    hang = Constraints(
        hang.n_dofs, hang.slave[table_sel], hang.masters[table_sel],
        hang.weights[table_sel],
    )

    # constraint tables in slot space
    _, d_flat, _ = slots_of(fmt, dirichlet)
    _, sl_flat, sl_grp = slots_of(fmt, hang.slave)
    master_rep = fmt.rep_slot[hang.masters]  # [n_sl, Kc]
    # C^T: add w*val to the REP slot of each master, then broadcast the rep
    # value to the master's duplicate slots
    if len(hang.slave):
        nz = hang.weights != 0
        si, ki = np.nonzero(nz)
        m_dofs = hang.masters[si, ki]
        ct_target = fmt.rep_slot[m_dofs]
        ct_src = si
        ct_w = hang.weights[si, ki]
        uniq_masters = np.unique(m_dofs)
        _, mf, mg = slots_of(fmt, uniq_masters)
        rep = fmt.rep_slot[uniq_masters][mg]
        nonrep = mf != rep
        refresh_slots = mf[nonrep]
        refresh_src = rep[nonrep]
    else:
        ct_target = np.zeros(0, np.int64)
        ct_src = np.zeros(0, np.int64)
        ct_w = np.zeros(0)
        refresh_slots = np.zeros(0, np.int64)
        refresh_src = np.zeros(0, np.int64)

    constrained = np.unique(np.concatenate([dirichlet, full_slaves])).astype(np.int64)
    _, c_flat, _ = slots_of(fmt, constrained)
    dirichlet_keep = np.ones(fmt.n_slots, np.float32)
    dirichlet_keep[d_flat] = 0.0
    slave_keep = np.ones(fmt.n_slots, np.float32)
    slave_keep[sl_flat] = 0.0
    constrained_keep = np.ones(fmt.n_slots, np.float32)
    constrained_keep[c_flat] = 0.0

    # size-bucketed irregular exchange tables: bucket s holds the groups of
    # exactly s slots, so no slot table carries padding
    irr_buckets = []
    if fmt.irr_slots.shape[0]:
        counts = (fmt.irr_slots < fmt.n_slots).sum(axis=1)
        for s in np.unique(counts):
            gsel = np.nonzero(counts == s)[0]
            gmap = np.full(fmt.irr_slots.shape[0], -1, np.int64)
            gmap[gsel] = np.arange(len(gsel))
            osel = gmap[fmt.irr_out_group] >= 0
            irr_buckets.append(
                (
                    fmt.irr_slots[gsel, :s],
                    fmt.irr_out_slots[osel],
                    gmap[fmt.irr_out_group[osel]],
                )
            )
    Kc = max(hang.masters.shape[1], 1)

    # patch<->singleton cross-exchange tables + overlap-assembly matrix
    n1p = p + 1
    cross = []
    for t in fmt.cross_faces or (None,) * 6:
        if t is None:
            cross.append(None)
        else:
            pidx, b1, b2, sidx = t
            cross.append((pidx * fmt.K * fmt.K + b1 * fmt.K + b2, sidx))
    Easm = np.zeros((S, fmt.K * n1p))
    for b in range(fmt.K):
        Easm[b * p : b * p + n1p, b * n1p : b * n1p + n1p] = np.eye(n1p)

    tables = {
        "KS": KS,
        "MS": MS,
        "elem": elem_m,
        "pscale": h_p,
        "sscale": h_s,
        "nbr": np.maximum(fmt.nbr, 0),
        "nbr_mask": (fmt.nbr >= 0).astype(np.float64),
        # pre-reordered for the [cell, z, y, x] singleton lattice axes
        "snbr": np.maximum(fmt.nbr_s[SINGLE_SWEEP_ROWS], 0),
        "snbr_mask": (fmt.nbr_s[SINGLE_SWEEP_ROWS] >= 0).astype(np.float64),
        "irr_buckets": tuple(irr_buckets),
        "dirichlet_keep": dirichlet_keep,
        "slave_keep": slave_keep,
        "constrained_keep": constrained_keep,
        "slave_master_slots": (
            master_rep if master_rep.size else np.zeros((0, Kc), np.int64)
        ),
        "slave_w": hang.weights if hang.weights.size else np.zeros((0, Kc)),
        "slave_all_slots": sl_flat,
        "slave_all_src": sl_grp,
        "slave_rep": (
            fmt.rep_slot[hang.slave] if len(hang.slave) else np.zeros(0, np.int64)
        ),
        "ct_target": ct_target,
        "ct_src": ct_src,
        "ct_w": ct_w,
        "refresh_slots": refresh_slots,
        "refresh_src": refresh_src,
        "owner": fmt.owner,
        "sf_patch": tuple(sf_patch),
        "sf_single": tuple(sf_single),
        "sf_patch_rows": tuple(sf_patch_rows),
        "sf_E1": E1,
        "sf_slave_keep": sf_slave_keep,
        "sf_Eh": np.stack([Eh[0], Eh[1]]),
        "cross": tuple(cross),
        "Easm": Easm,
    }
    meta = {
        "use_ssweep": bool(fmt.use_singleton_sweeps),
        "use_cross": bool(fmt.use_cross),
        "NP": fmt.n_patches,
        "NS": fmt.n_singles,
        "S": fmt.S,
        "nloc": dofh.n_loc,
        "n_slots": fmt.n_slots,
        "n_dofs": dofh.n_dofs,
        "sf_levels": tuple(int(l) for l in sf_levels),
        "sf_patch_rows_meta": tuple(sf_patch_rows_meta),
        "sf_c_rounds": sf_c_rounds,
        "sf_ct_rounds": sf_ct_rounds,
    }
    return tables, meta
