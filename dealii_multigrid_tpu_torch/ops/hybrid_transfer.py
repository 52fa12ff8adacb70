"""Two-level transfers in the hybrid patch layout, on torch.

Same global linear maps as the JAX package's ops/hybrid_transfer.py (nodal
interpolation of the constraint-distributed coarse function; restriction is
its exact transpose), executed patch-structured:

  * h-transfer: fine K^3 patches bucket by parent octant; the coarse source
    is a static strided sub-lattice window of the parent coarse patch,
    interpolated by three axis GEMMs with the 1D patch embedding E1.
    Patches that exist on both levels are whole-patch copies (``id_bucket``),
    or, when the coarse level uses half the patch size, eight octant window
    copies (``id_oct``) or one whole-coarse-patch parent.
  * p-transfer: patch-to-patch pairing with the 1D degree embedding.
  * fallback: fine patches whose coarse source is not patch-covered gather
    their sub-lattice through a slot table (``irr_patch``, ``irr_id``);
    fine singleton cells gather their source cell's nodes the same way
    (``single_buckets``) or as whole coarse-singleton rows (``single_fast``).

``hybrid_transfer_tables`` builds the host tables (NumPy, the JAX package's
construction without its TPU lane-routing matrices); ``HybridTransfer``
applies them.  With ``ls_mode`` (the local-smoothing levels, whose
Dirichlet set is boundary plus refinement edge) the same tables run without
the constraints: prolong skips C and the constrained mask, restrict masks by
ownership only, and the coarse tail is the exchange alone.  Every padded
row index points at an explicit zero row that the apply appends, never out
of range.  Restriction's slot-table scatters (``irr_patch``, ``irr_id``,
the singleton buckets) add through one fixed-order table
(ops/fixed_order.py), so a float32 restriction is bit-repeatable on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.dof import local_node_indices
from ..mesh.octree import morton_encode
from . import tensor
from .fixed_order import FixedOrderSum
from .hybrid import HybridOperator, tables_to_device
from .hybrid_format import HybridFormat, cell_slot_table


def _axis_apply(u: torch.Tensor, mat: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(torch.tensordot(u, mat, dims=([axis], [1])), -1, axis)


class HybridTransfer:
    """Prolongation / restriction between two hybrid levels on one device."""

    #: device tables (the JAX HybridTransfer's data fields of the plain path;
    #: its id_oct entries carry a third, TPU lane-routing element not used here)
    TABLE_KEYS = (
        "E1", "patch_buckets", "id_bucket", "id_oct", "irr_patch", "irr_id",
        "single_buckets", "single_fast",
    )
    #: static metadata
    META_KEYS = (
        "patch_offsets", "id_oct_offsets", "S_f", "S_c", "sub", "NP_f", "NS_f",
        "nloc_f", "n_slots_f", "n_slots_c",
    )

    def __init__(self, t: dict, meta: dict, fine_op: HybridOperator,
                 coarse_op: HybridOperator, ls_mode: bool = False):
        self.coarse_op = coarse_op
        self.ls_mode = ls_mode
        self.fine_constrained_keep = fine_op.constrained_keep
        self.fine_owner = fine_op.owner
        for k, v in meta.items():
            setattr(self, k, v)
        for k, v in t.items():
            setattr(self, k, v)

    @classmethod
    def from_arrays(cls, tables: dict, meta: dict, fine_op: HybridOperator,
                    coarse_op: HybridOperator, device: torch.device,
                    dtype: torch.dtype, ls_mode: bool = False) -> "HybridTransfer":
        """Build from host tables (``hybrid_transfer_tables`` or the JAX
        transfer's data leaves as NumPy arrays, same keys)."""
        tr = cls(tables_to_device(tables, device, dtype), meta, fine_op, coarse_op, ls_mode)
        tr.restrict_sum = _restrict_sum(tables, meta, coarse_op.patch_slots, device)
        return tr

    def _interp_sub(self, sub_vals: torch.Tensor) -> torch.Tensor:
        """[n, sub, sub, sub] -> [n, S_f, S_f, S_f] via three axis GEMMs."""
        v = _axis_apply(sub_vals, self.E1, 1)
        v = _axis_apply(v, self.E1, 2)
        return _axis_apply(v, self.E1, 3)

    def _interp_sub_t(self, v: torch.Tensor) -> torch.Tensor:
        ET = self.E1.T
        r = _axis_apply(v, ET, 1)
        r = _axis_apply(r, ET, 2)
        return _axis_apply(r, ET, 3)

    def prolong(self, uc: torch.Tensor) -> torch.Tensor:
        cop = self.coarse_op
        if not self.ls_mode:
            uc = cop.apply_c(uc)
        dtype, dev = uc.dtype, uc.device
        S_c, S_f, sub = self.S_c, self.S_f, self.sub
        ps_f = self.NP_f * S_f**3
        out = torch.zeros(self.n_slots_f, dtype=dtype, device=dev)
        out_p = out[:ps_f].view(self.NP_f, S_f, S_f, S_f)
        if cop.NP and self.NP_f:
            up_c = cop._patches(uc)
            for (fidx, cidx, _ch), (ox, oy, oz) in zip(
                self.patch_buckets, self.patch_offsets
            ):
                sv = up_c[:, ox : ox + sub, oy : oy + sub, oz : oz + sub][cidx]
                out_p[fidx] = self._interp_sub(sv)
            if self.id_bucket is not None:
                fidx, cidx = self.id_bucket
                out_p[fidx] = up_c[cidx]
            if self.id_oct:
                # src_rows pads with NP_c: the appended zero patch
                up_pad = torch.cat([up_c, up_c.new_zeros((1,) + up_c.shape[1:])])
                for (src_rows, _fr), (dx, dy, dz) in zip(
                    self.id_oct, self.id_oct_offsets
                ):
                    g = up_pad[src_rows]
                    out_p[
                        :,
                        dx * S_c : dx * S_c + S_c - dx,
                        dy * S_c : dy * S_c + S_c - dy,
                        dz * S_c : dz * S_c + S_c - dz,
                    ] += g[:, dx:, dy:, dz:]
        if self.irr_patch is not None:
            fidx, sub_slots = self.irr_patch
            sv = uc[sub_slots].view(-1, sub, sub, sub)
            out_p[fidx] = self._interp_sub(sv)
        if self.irr_id is not None:
            fidx, slots = self.irr_id
            out_p[fidx] = uc[slots].view(-1, S_f, S_f, S_f)
        if self.NS_f:
            out_s = out[ps_f:].view(self.NS_f, self.nloc_f)
            for sidx, src_slots, M in self.single_buckets:
                out_s[sidx] = torch.matmul(uc[src_slots], M.T)
            if self.single_fast:
                us_c = cop._singles(uc)
                for sidx, crow, M in self.single_fast:
                    out_s[sidx] = torch.matmul(us_c[crow], M.T)
        if self.ls_mode:
            return out
        return out * self.fine_constrained_keep

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        cop = self.coarse_op
        if self.ls_mode:
            rf = rf * self.fine_owner
        else:
            rf = rf * self.fine_constrained_keep * self.fine_owner
        dtype, dev = rf.dtype, rf.device
        S_c, S_f, sub = self.S_c, self.S_f, self.sub
        acc = torch.zeros(self.n_slots_c, dtype=dtype, device=dev)
        rp = rf[: self.NP_f * S_f**3].view(self.NP_f, S_f, S_f, S_f)
        if cop.NP and self.NP_f:
            acc_p = cop._patches(acc)
            for (fidx, cidx, child_rows), (ox, oy, oz) in zip(
                self.patch_buckets, self.patch_offsets
            ):
                v = self._interp_sub_t(rp[fidx])
                # every coarse patch has at most ONE fine child per octant
                # (checked at build time): the window update is a row gather
                # (child_rows pads with len(fidx): the appended zero row)
                vpad = torch.cat([v, v.new_zeros((1, sub, sub, sub))])
                acc_p[:, ox : ox + sub, oy : oy + sub, oz : oz + sub] += vpad[child_rows]
            if self.id_bucket is not None:
                # one fine patch per coarse patch (checked at build time):
                # one addition per target, exact and repeatable
                fidx, cidx = self.id_bucket
                acc_p.index_add_(0, cidx, rp[fidx])
            for (_sr, fine_rows), (dx, dy, dz) in zip(
                self.id_oct, self.id_oct_offsets
            ):
                win = rp[
                    :,
                    dx * S_c : dx * S_c + S_c - dx,
                    dy * S_c : dy * S_c + S_c - dy,
                    dz * S_c : dz * S_c + S_c - dz,
                ]
                # fine_rows pads with NP_f: the appended zero window
                wpad = torch.cat([win, win.new_zeros((1,) + win.shape[1:])])
                acc_p[:, dx:, dy:, dz:] += wpad[fine_rows]
        # the slot-table scatters, in the order of restrict_sum's sources
        parts = []
        if self.irr_patch is not None:
            parts.append(self._interp_sub_t(rp[self.irr_patch[0]]).reshape(-1))
        if self.irr_id is not None:
            parts.append(rp[self.irr_id[0]].reshape(-1))
        if self.NS_f:
            rs = rf[self.NP_f * S_f**3 :].view(self.NS_f, self.nloc_f)
            for sidx, _slots, M in self.single_buckets + self.single_fast:
                parts.append(torch.matmul(rs[sidx], M).reshape(-1))
        if parts:
            self.restrict_sum.add_into(acc, torch.cat(parts))
        return self._restrict_coarse_tail(acc)

    def _restrict_coarse_tail(self, acc: torch.Tensor) -> torch.Tensor:
        """Coarse-side assembly after the restriction accumulator: C^T on
        structured faces, exchange, per-node C^T (the exchange alone in
        ``ls_mode``)."""
        cop = self.coarse_op
        if self.ls_mode:
            return cop.exchange(acc)
        acc = cop.apply_ct_faces(acc)
        acc = cop.exchange(acc)
        return cop.apply_ct(acc)


def _h_patch_embedding_1d(K: int, degree: int) -> np.ndarray:
    """[S_f, (K/2)*p+1]: fine K-cell patch nodes from the coarse (K/2)-cell
    sub-lattice (one global-coarsening step)."""
    p = degree
    Eh = tensor.h_embedding_1d(p)
    S_f = K * p + 1
    sub = (K // 2) * p + 1
    out = np.zeros((S_f, sub))
    for kf in range(K):
        kc, b = kf >> 1, kf & 1
        out[kf * p : kf * p + p + 1, kc * p : kc * p + p + 1] = Eh[b]
    return out


def _p_patch_embedding_1d(K: int, deg_c: int, deg_f: int) -> np.ndarray:
    Ep = tensor.p_embedding_1d(deg_c, deg_f)
    S_f = K * deg_f + 1
    S_c = K * deg_c + 1
    out = np.zeros((S_f, S_c))
    for k in range(K):
        out[k * deg_f : k * deg_f + deg_f + 1, k * deg_c : k * deg_c + deg_c + 1] = Ep
    return out


def _kron3(E: np.ndarray) -> np.ndarray:
    return np.kron(np.kron(E, E), E)


def hybrid_transfer_tables(
    fine_fmt: HybridFormat, coarse_fmt: HybridFormat
) -> tuple[dict, dict]:
    """Host tables of the two-level transfer (fine level above coarse).

    Returns ``(tables, meta)`` keyed like the JAX HybridTransfer's data and
    static fields (plain path: no lane-routing one-hots); float tables in
    float64, index tables as integers."""
    fd, cd = fine_fmt.dofh, coarse_fmt.dofh
    mf, mc = fd.mesh, cd.mesh
    p_f, p_c = fd.degree, cd.degree
    K = fine_fmt.K
    same_mesh = (
        mf.n_cells == mc.n_cells
        and np.array_equal(mf.level, mc.level)
        and np.array_equal(mf.anchor, mc.anchor)
    )
    cslot = cell_slot_table(coarse_fmt)
    nloc_c = cd.n_loc
    loc_c = local_node_indices(3, p_c)

    # coarse cell -> coarse singleton row (or -1): sources that are coarse
    # singletons use whole-row block gathers instead of slot tables
    srow_c = np.full(mc.n_cells, -1, np.int64)
    real_c = np.nonzero(coarse_fmt.single_cells >= 0)[0]
    srow_c[coarse_fmt.single_cells[real_c]] = real_c

    single_buckets_out: list = []
    single_fast_out: list = []

    def add_single_bucket(sidx_arr, cells_arr, M):
        """Route a singleton bucket through the fast (coarse-singleton-row)
        or the slot-table path, splitting mixed buckets."""
        fast = srow_c[cells_arr] >= 0
        if fast.any():
            single_fast_out.append(
                (sidx_arr[fast], srow_c[cells_arr[fast]], M)
            )
        if (~fast).any():
            single_buckets_out.append(
                (sidx_arr[~fast], cslot[cells_arr[~fast]], M)
            )

    # coarse patch lookup (level, block) -> idx (only same-K decompositions)
    cp_key = {}
    if coarse_fmt.K == K:
        for i in range(coarse_fmt.n_patches):
            cp_key[
                (
                    int(coarse_fmt.patch_level[i]),
                    int(coarse_fmt.patch_block[i, 0]),
                    int(coarse_fmt.patch_block[i, 1]),
                    int(coarse_fmt.patch_block[i, 2]),
                )
            ] = i
    # half-K coarse decomposition (adaptive per-level patch granularity,
    # K_coarse = K_fine/2): a fine K-patch's one-level-coarser region is
    # exactly ONE whole half-K coarse patch (the parent case rides the
    # existing sub-window machinery with off=(0,0,0), sub == S_c), and its
    # same-level region is exactly EIGHT half-K coarse patches (octants —
    # the id_oct buckets below)
    cp_key_h = {}
    if K > 1 and coarse_fmt.K == K // 2:
        for i in range(coarse_fmt.n_patches):
            if int(coarse_fmt.patch_level[i]) < 0:  # padding dummy
                continue
            cp_key_h[
                (
                    int(coarse_fmt.patch_level[i]),
                    int(coarse_fmt.patch_block[i, 0]),
                    int(coarse_fmt.patch_block[i, 1]),
                    int(coarse_fmt.patch_block[i, 2]),
                )
            ] = i

    # coarse active-cell lookup
    cindex = {}
    for l in np.unique(mc.level):
        sel = np.nonzero(mc.level == l)[0]
        codes = morton_encode(mc.anchor[sel])
        order = np.argsort(codes)
        cindex[int(l)] = (codes[order], sel[order])

    def find_cell(level, anchors):
        got = cindex.get(int(level))
        if got is None:
            return np.full(len(anchors), -1, np.int64)
        codes_sorted, gidx = got
        q = morton_encode(anchors)
        pos = np.minimum(np.searchsorted(codes_sorted, q), len(codes_sorted) - 1)
        return np.where(codes_sorted[pos] == q, gidx[pos], -1)

    patch_buckets = []
    id_pairs = ([], [])
    id_oct_groups = {o: ([], []) for o in range(8)}
    irr_f, irr_slots_list = [], []
    irr_id_f, irr_id_slots = [], []

    if same_mesh:
        assert p_f != p_c
        sub = coarse_fmt.S
        E1 = _p_patch_embedding_1d(K, p_c, p_f)
        # patch pairing is identical by construction
        pair = np.arange(fine_fmt.n_patches, dtype=np.int64)
        if coarse_fmt.K == K and coarse_fmt.n_patches == fine_fmt.n_patches:
            patch_buckets.append((pair, pair, (0, 0, 0)))
        else:  # degenerate: route through irregular sub-lattice
            for i in range(fine_fmt.n_patches):
                if fine_fmt.patch_level[i] < 0:  # padding dummy
                    continue
                irr_f.append(i)
                irr_slots_list.append(
                    _sub_slots_same_mesh(fine_fmt, coarse_fmt, i, cslot, loc_c, p_c)
                )
        M_single = _kron3(tensor.p_embedding_1d(p_c, p_f))
        # same mesh => same singleton cells in both formats (skip dummies)
        sidx = np.nonzero(fine_fmt.single_cells >= 0)[0].astype(np.int64)
        if len(sidx):
            add_single_bucket(sidx, fine_fmt.single_cells[sidx], M_single)
    else:
        assert p_f == p_c
        p = p_f
        if K > 1:
            sub = (K // 2) * p + 1
            E1 = _h_patch_embedding_1d(K, p)
        else:  # no fine patches (singleton-only level)
            sub = 1
            E1 = np.ones((fine_fmt.S, 1))
        # --- fine patches ---
        oct_groups = {o: ([], []) for o in range(8)}
        half_parent: tuple[list, list] = ([], [])
        for i in range(fine_fmt.n_patches):
            lvl = int(fine_fmt.patch_level[i])
            if lvl < 0:  # padding dummy
                continue
            blk = fine_fmt.patch_block[i]
            # identity: same patch in coarse decomposition
            j = cp_key.get((lvl, int(blk[0]), int(blk[1]), int(blk[2])))
            if j is not None:
                id_pairs[0].append(i)
                id_pairs[1].append(j)
                continue
            # identity across K: the fine patch's region = 8 half-K coarse
            # patches (one per octant), values copy without interpolation
            if cp_key_h:
                subs_j = [
                    cp_key_h.get(
                        (
                            lvl,
                            int(2 * blk[0] + (o & 1)),
                            int(2 * blk[1] + ((o >> 1) & 1)),
                            int(2 * blk[2] + ((o >> 2) & 1)),
                        )
                    )
                    for o in range(8)
                ]
                if all(sj is not None for sj in subs_j):
                    for o, sj in enumerate(subs_j):
                        id_oct_groups[o][0].append(i)
                        id_oct_groups[o][1].append(sj)
                    continue
                # parent across K: one whole half-K coarse patch at lvl-1
                jp_h = cp_key_h.get(
                    (lvl - 1, int(blk[0]), int(blk[1]), int(blk[2]))
                )
                if jp_h is not None:
                    half_parent[0].append(i)
                    half_parent[1].append(jp_h)
                    continue
            # identity cells present in coarse but not patch-covered there
            ident_cells = find_cell(lvl, mf.anchor[fine_fmt.patch_cells[i]])
            if (ident_cells >= 0).all():
                lat, _ = _lattice_cells(p, K, loc_c)
                slots = np.full(fine_fmt.S**3, -1, np.int64)
                slots[lat.reshape(-1)] = cslot[ident_cells].reshape(-1)
                assert (slots >= 0).all()
                irr_id_f.append(i)
                irr_id_slots.append(slots)
                continue
            # parent half-patch
            o = int((blk[0] & 1) | ((blk[1] & 1) << 1) | ((blk[2] & 1) << 2))
            jp = cp_key.get(
                (lvl - 1, int(blk[0] >> 1), int(blk[1] >> 1), int(blk[2] >> 1))
            )
            if jp is not None:
                oct_groups[o][0].append(i)
                oct_groups[o][1].append(jp)
            else:
                irr_f.append(i)
                irr_slots_list.append(
                    _sub_slots_h(fine_fmt, i, mc, find_cell, cslot, loc_c, p, K, sub)
                )
        half = (K // 2) * p
        for o, (fi, ci) in oct_groups.items():
            if fi:
                off = ((o & 1) * half, ((o >> 1) & 1) * half, ((o >> 2) & 1) * half)
                patch_buckets.append(
                    (np.asarray(fi, np.int64), np.asarray(ci, np.int64), off)
                )
        if half_parent[0]:
            # K_c = K/2 parent: the coarse patch IS the fine patch's whole
            # one-level-coarser region — off (0,0,0), window = full coarse
            # patch (sub == S_c), same E1 interpolation
            patch_buckets.append(
                (
                    np.asarray(half_parent[0], np.int64),
                    np.asarray(half_parent[1], np.int64),
                    (0, 0, 0),
                )
            )
        # --- fine singles: identity cell or parent cell ---
        if fine_fmt.n_singles:
            real_sel = np.nonzero(fine_fmt.single_cells >= 0)[0]
            scells = fine_fmt.single_cells[real_sel]
            lvls = mf.level[scells]
            anch = mf.anchor[scells]
            ident = np.full(len(scells), -1, np.int64)
            for l in np.unique(lvls):
                s = lvls == l
                ident[s] = find_cell(l, anch[s])
            id_sel = ident >= 0
            if id_sel.any():
                add_single_bucket(
                    real_sel[id_sel].astype(np.int64),
                    ident[id_sel],
                    np.eye(fd.n_loc),
                )
            rest = np.nonzero(~id_sel)[0]
            if len(rest):
                par = np.full(len(rest), -1, np.int64)
                octs = np.zeros(len(rest), np.int64)
                for l in np.unique(lvls[rest]):
                    s = lvls[rest] == l
                    cells = rest[s]
                    par[s] = find_cell(l - 1, anch[cells] >> 1)
                    bits = anch[cells] & 1
                    octs[s] = bits[:, 0] | (bits[:, 1] << 1) | (bits[:, 2] << 2)
                assert (par >= 0).all(), "fine singleton without coarse source"
                Eh = tensor.h_embedding_1d(p)
                for o in range(8):
                    s = octs == o
                    if s.any():
                        M = np.kron(
                            np.kron(Eh[(o >> 2) & 1], Eh[(o >> 1) & 1]), Eh[o & 1]
                        )
                        add_single_bucket(
                            real_sel[rest[s]].astype(np.int64), par[s], M
                        )


    id_bucket = None
    if id_pairs[0]:
        id_bucket = (np.asarray(id_pairs[0]), np.asarray(id_pairs[1]))
    irr_id = None
    if irr_id_f:
        irr_id = (np.asarray(irr_id_f), np.stack(irr_id_slots))
    irr_patch = None
    if irr_f:
        irr_patch = (np.asarray(irr_f), np.stack(irr_slots_list))

    # identity-across-K octant buckets: dense whole-bucket window updates via
    # a [NP_f]-row (src_rows) / [NP_c]-row (fine_rows) gather whose pad row
    # is an appended zero row.  Octant windows are TRIMMED on their low-side
    # shared plane so every fine slot has exactly one writer in prolong, and
    # restrict routes each masked fine contribution to exactly one coarse
    # copy (the coarse exchange completes the sums).
    id_oct = []
    id_oct_offsets = []
    for o in range(8):
        fi, ci = id_oct_groups[o]
        if not fi:
            continue
        f_arr = np.asarray(fi, np.int64)
        c_arr = np.asarray(ci, np.int64)
        src_rows = np.full(fine_fmt.n_patches, coarse_fmt.n_patches, np.int64)
        src_rows[f_arr] = c_arr
        fine_rows = np.full(coarse_fmt.n_patches, fine_fmt.n_patches, np.int64)
        assert len(np.unique(c_arr)) == len(c_arr), "coarse patch in 2 octants"
        fine_rows[c_arr] = f_arr
        id_oct.append((src_rows, fine_rows))
        id_oct_offsets.append((o & 1, (o >> 1) & 1, (o >> 2) & 1))

    def child_rows_of(f, c):
        # one fine child per (coarse patch, octant): restrict's window update
        # inverts the map into a row gather (see HybridTransfer.restrict)
        assert len(np.unique(c)) == len(c), "duplicate coarse patch in octant"
        rows = np.full(coarse_fmt.n_patches, len(f), np.int64)
        rows[c] = np.arange(len(f))
        return rows

    tables = {
        "E1": E1,
        "patch_buckets": tuple(
            (np.asarray(f, np.int64), np.asarray(c, np.int64), child_rows_of(f, c))
            for f, c, off in patch_buckets
        ),
        "id_bucket": id_bucket,
        "id_oct": tuple(id_oct),
        "irr_patch": irr_patch,
        "irr_id": irr_id,
        "single_buckets": tuple(single_buckets_out),
        "single_fast": tuple(single_fast_out),
    }
    meta = {
        "patch_offsets": tuple(
            tuple(int(x) for x in off) for f, c, off in patch_buckets
        ),
        "id_oct_offsets": tuple(id_oct_offsets),
        "S_f": fine_fmt.S,
        "S_c": coarse_fmt.S,
        "sub": sub,
        "NP_f": fine_fmt.n_patches,
        "NS_f": fine_fmt.n_singles,
        "nloc_f": fd.n_loc,
        "n_slots_f": fine_fmt.n_slots,
        "n_slots_c": coarse_fmt.n_slots,
    }
    return tables, meta


def _restrict_sum(t: dict, meta: dict, patch_slots_c: int, device) -> FixedOrderSum | None:
    """The fixed-order table of restriction's slot-table scatters: the
    coarse slot of every source value of ``irr_patch``, ``irr_id``, the
    singleton buckets and the whole-row singleton buckets, in that order."""
    if t["id_bucket"] is not None:
        cidx = np.asarray(t["id_bucket"][1])
        assert len(np.unique(cidx)) == len(cidx), "coarse patch with two identity children"
    targets = []
    for key in ("irr_patch", "irr_id"):
        if t[key] is not None:
            targets.append(np.asarray(t[key][1]).reshape(-1))
    for _sidx, slots, _M in t["single_buckets"]:
        targets.append(np.asarray(slots).reshape(-1))
    for _sidx, crow, M in t["single_fast"]:
        nloc_c = np.asarray(M).shape[1]
        targets.append(
            (patch_slots_c + np.asarray(crow)[:, None] * nloc_c + np.arange(nloc_c)).reshape(-1)
        )
    if not targets:
        return None
    return FixedOrderSum.build(np.concatenate(targets), meta["n_slots_c"], device)


def make_hybrid_transfer(fine_fmt, coarse_fmt, fine_op: HybridOperator,
                         coarse_op: HybridOperator, ls_mode: bool = False) -> HybridTransfer:
    """Host tables -> device transfer on the operators' device and dtype."""
    tables, meta = hybrid_transfer_tables(fine_fmt, coarse_fmt)
    return HybridTransfer.from_arrays(
        tables, meta, fine_op, coarse_op, coarse_op.device, coarse_op.dtype, ls_mode
    )


def _lattice_cells(p: int, ncell: int, loc: np.ndarray):
    """Map (cell position in sub-block, local node) -> sub-lattice flat index."""
    sub = ncell * p + 1
    bidx = np.empty((ncell**3, 3), dtype=np.int64)
    f = np.arange(ncell**3)
    for d in range(3):
        bidx[:, d] = (f // ncell**d) % ncell
    TX = bidx[:, None, 0] * p + loc[None, :, 0]
    TY = bidx[:, None, 1] * p + loc[None, :, 1]
    TZ = bidx[:, None, 2] * p + loc[None, :, 2]
    return (TX * sub + TY) * sub + TZ, bidx  # [ncell^3, nloc]


def _sub_slots_h(fmt_f, i, mc, find_cell, cslot, loc_c, p, K, sub):
    """Irregular coarse sub-lattice slots for one fine patch (h-transfer)."""
    lvl = int(fmt_f.patch_level[i])
    blk = fmt_f.patch_block[i]
    nc = K // 2
    lat, bidx = _lattice_cells(p, nc, loc_c)
    out = np.full(sub**3, -1, dtype=np.int64)
    # coarse cells covering the fine patch: anchors blk*(K//1)... fine patch
    # spans K cells at lvl = nc cells at lvl-1 starting at blk*K//2
    base = blk * (K // 2)
    anchors = base[None, :] + bidx
    cells = find_cell(lvl - 1, anchors)
    if (cells < 0).any():
        # mixed: some regions unrefined (identity cells at lvl)
        # fall back to identity cells at lvl for the missing ones
        miss = np.nonzero(cells < 0)[0]
        raise AssertionError(
            "irregular h-transfer patch with mixed-level coarse source"
        )
    out[lat.reshape(-1)] = cslot[cells].reshape(-1)
    assert (out >= 0).all()
    return out


def _sub_slots_same_mesh(fmt_f, fmt_c, i, cslot, loc_c, p_c):
    """Irregular coarse sub-lattice for one fine patch (p-transfer with
    mismatched decompositions)."""
    K = fmt_f.K
    lvl = int(fmt_f.patch_level[i])
    lat, bidx = _lattice_cells(p_c, K, loc_c)
    sub = K * p_c + 1
    out = np.full(sub**3, -1, dtype=np.int64)
    cells = fmt_f.patch_cells[i]  # same mesh: same cell ids
    out[lat.reshape(-1)] = cslot[cells].reshape(-1)
    assert (out >= 0).all()
    return out
