"""The hybrid operator on one rank's span of a device-major level.

A level laid out device-major (ops/hybrid_format.repartition_format, D > 1
spans) is applied by D ranks, each on its own span: its patches, then its
singletons.  Every stage keeps the single-device algorithm
(ops/hybrid.py) and restricts it to the outputs this rank owns; what a
stage reads from other ranks arrives first through one ghost import
(parallel/comm.GhostImport), into a buffer appended to the rank's vector:

  * ``apply_c``: the hanging masters the rank's slaves read; per structured
    round, the coarse face sub-planes its fine faces read;
  * ``apply_ct_faces``: per round, the rank computes the contributions into
    the coarse face slots it owns, importing the fine face planes that
    other ranks hold;
  * ``exchange``: the raw values of the irregular groups the rank
    overwrites; then per axis, after the previous axis's writes, the face
    planes of neighbouring patches and singletons on other ranks (and the
    singleton and patch planes the patch<->singleton cross terms read);
  * ``apply_ct``: the slave representatives whose C^T lands on the rank's
    masters, then the master representatives of its duplicate slots;
  * ``dot``: the owned partial sum, added over ranks in rank order.

Every sum keeps the one-device table's order restricted to the rank's
targets (ops/fixed_order.py), so a float32 apply is bit-repeatable run to
run at any rank count.  Imports are surface-sized: face planes, irregular
groups, hanging masters.  The stencil kernel runs on the rank's
``NP / D`` patches; dummy patches carry ``pscale`` 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.comm import Comm, ExtIndex, GhostImport, SlotPart, current_comm
from ..utils.device import to_tensor
from .fixed_order import FixedOrderSum
from .hybrid import HybridOperator, _last_writers, tables_to_device
from .hybrid_transfer import HybridTransfer, _prolong_core, _restrict_core, restrict_targets
from .patch_stencil import matrix_band

#: tables the rank keeps whole (level-independent small matrices)
_WHOLE = ("KS", "MS", "elem", "sf_E1", "sf_Eh", "Easm")
#: per-slot masks, cut to the rank's span
_MASKS = ("dirichlet_keep", "slave_keep", "constrained_keep", "owner", "sf_slave_keep")


def _plane_offsets(n: int, axis: int, side: int) -> np.ndarray:
    """[n, n] offsets of a lattice face plane inside one ``[n, n, n]`` block
    (``axis`` 1-3 as in ``x.view(-1, n, n, n).select(axis, ...)``)."""
    return np.take(np.arange(n**3).reshape(n, n, n), (n - 1) if side else 0, axis=axis - 1)


class _Planes:
    """The ghost face planes one exchange axis reads: for each (bucket,
    side) the remote items whose plane is needed, and one import."""

    def __init__(self, part: SlotPart):
        self.part = part
        self.need = {}  # (bucket, side) -> set of item ids

    def add(self, bucket: str, side: int, items, own) -> None:
        items = np.asarray(items, np.int64)
        items = items[(items >= 0) & ~own(items)]
        self.need.setdefault((bucket, side), []).append(items)

    def finish(self, comm, fmt, axes: dict, n1: int, device):
        """-> (import, [(bucket, side, n_items, plane edge)], ext maps)."""
        p = self.part
        keys, want, maps = [], [], {}
        for bucket in ("p", "s"):
            for side in (0, 1):
                got = self.need.get((bucket, side))
                items = np.unique(np.concatenate(got)) if got else np.zeros(0, np.int64)
                if bucket == "p":
                    n, base, lo, n_own = fmt.S, fmt.patch_slot_base(items), p.p_lo, p.pps
                else:
                    n, base, lo, n_own = n1, fmt.single_slot_base(items), p.s_lo, p.sps
                off = _plane_offsets(n, axes[bucket], side)
                want.append((base[:, None, None] + off[None]).reshape(-1))
                keys.append((bucket, side, len(items), n))
                maps[(bucket, side)] = (items, lo, n_own)
        imp = GhostImport.build(comm, p, np.concatenate(want), device)
        return imp, keys, maps


def _ext_items(maps, key, ids) -> np.ndarray:
    """Item ids -> rows of the (own | ghost) plane stack of ``key``; a
    missing neighbour (-1, masked to zero by its caller) reads row 0."""
    items, lo, n_own = maps[key]
    ids = np.asarray(ids, np.int64)
    own = ((ids >= lo) & (ids < lo + n_own)) | (ids < 0)
    out = np.where(own & (ids >= 0), ids - lo, 0)
    if (~own).any():
        pos = np.searchsorted(items, ids[~own])
        assert (items[np.minimum(pos, len(items) - 1)] == ids[~own]).all()
        out[~own] = n_own + pos
    return out


class RankHybridOperator(HybridOperator):
    """HybridOperator on one rank's span of a device-major level (see the
    module docstring).  Vectors are the rank's span; ``NP``, ``NS`` and
    ``n_slots`` are the rank's patches, singletons and span."""

    @classmethod
    def build(cls, tables: dict, meta: dict, fmt, device, dtype,
              comm: Comm | None = None) -> "RankHybridOperator":
        comm = comm or current_comm()
        part = SlotPart.of(fmt, comm.rank)
        assert part.sharded, "a rank operator is for a sharded level"
        pl, sl = part.p_lo, part.s_lo
        t = {k: tables[k] for k in _WHOLE}
        t["pscale"] = tables["pscale"][pl : pl + part.pps]
        t["sscale"] = tables["sscale"][sl : sl + part.sps]
        for k in _MASKS:
            t[k] = part.slice(tables[k])
        m = dict(meta, NP=part.pps, NS=part.sps, n_slots=part.span)
        op = cls(tables_to_device(t, device, dtype), m, device, dtype,
                 matrix_band(tables["KS"], tables["MS"]))
        op.part, op.comm, op.fmt = part, comm, fmt
        op._build_stages(tables, meta, fmt, device, dtype)
        return op

    # ------------------------------------------------------------ set-up
    def _build_stages(self, t, meta, fmt, device, dtype) -> None:
        part, comm = self.part, self.comm
        lo = part.lo

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def val(a):
            return to_tensor(np.asarray(a, np.float64), device, dtype)

        # per-node C and C^T (global condition: the level has table slaves)
        self.c_node = self.ct_node = None
        if len(t["slave_rep"]):
            sl, src = t["slave_all_slots"], t["slave_all_src"]
            sel = part.own(sl)
            rows, src_l = np.unique(src[sel], return_inverse=True)
            M = t["slave_master_slots"][rows]
            ix = ExtIndex(part)
            ix.add(M)
            em = ix.finish(comm, device)
            self.c_node = (em, idx(sl[sel] - lo), idx(src_l), idx(em(M)),
                           val(t["slave_w"][rows]))

            e_sel = part.own(t["ct_target"])
            slaves, src_l = np.unique(t["ct_src"][e_sel], return_inverse=True)
            reps = t["slave_rep"][slaves]
            ix = ExtIndex(part)
            ix.add(reps)
            em = ix.finish(comm, device)
            ct_sum = FixedOrderSum.build(t["ct_target"][e_sel] - lo, part.span, device)
            refresh = None
            if len(t["refresh_slots"]):
                r_sel = part.own(t["refresh_slots"])
                ix = ExtIndex(part)
                ix.add(t["refresh_src"][r_sel])
                em2 = ix.finish(comm, device)
                refresh = (em2, idx(t["refresh_slots"][r_sel] - lo),
                           idx(em2(t["refresh_src"][r_sel])))
            self.ct_node = (em, idx(em(reps)), idx(src_l), ct_sum,
                            val(t["ct_w"][e_sel]), refresh)

        # structured hanging faces: C rounds (writers own their face) and
        # C^T rounds (the owner of a coarse target computes it)
        n_sf = len(meta["sf_levels"])
        c_rounds = meta["sf_c_rounds"] or tuple((i,) for i in range(n_sf))
        ct_rounds = meta["sf_ct_rounds"] or tuple((i,) for i in range(n_sf - 1, -1, -1))
        self.c_rounds_r = []
        for rnd in c_rounds:
            ix, parts, faces = ExtIndex(part), [], []
            for i in rnd:
                for kind, tbl in (("p", t["sf_patch"][i]), ("s", t["sf_single"][i])):
                    if tbl is None:
                        continue
                    face = np.asarray(tbl[0])
                    n = len(face)
                    own = part.own(face.reshape(n, -1))
                    sel = own[:, 0]
                    assert (own.all(1) == sel).all(), "a face split over ranks"
                    src = np.asarray(tbl[1])[sel]
                    ix.add(src)
                    extra = (tbl[3][sel], tbl[4][sel]) if kind == "s" else ()
                    parts.append((kind, src) + extra)
                    faces.append(face[sel].reshape(-1) - lo)
            em = ix.finish(comm, device)
            parts = [
                (kind, idx(em(src))) + tuple(idx(e) for e in extra)
                for kind, src, *extra in parts
            ]
            writes = _last_writers(np.concatenate(faces), device)
            self.c_rounds_r.append((em, parts, writes))
        self.ct_rounds_r = []
        for rnd in ct_rounds:
            ix, parts, targets = ExtIndex(part), [], []
            for i in rnd:
                for kind, tbl in (("p", t["sf_patch"][i]), ("s", t["sf_single"][i])):
                    if tbl is None:
                        continue
                    src = np.asarray(tbl[1])
                    n = len(src)
                    sel = part.own(src.reshape(n, -1)).any(1)
                    face = np.asarray(tbl[0])[sel]
                    ix.add(face)
                    extra = (tbl[3][sel], tbl[4][sel]) if kind == "s" else ()
                    parts.append((kind, face, np.asarray(tbl[2])[sel]) + extra)
                    tg = src[sel].reshape(-1)
                    targets.append(np.where(part.own(tg), tg - lo, -1))
            em = ix.finish(comm, device)
            parts = [
                (kind, idx(em(face)), val(mask)) + tuple(idx(e) for e in extra)
                for kind, face, mask, *extra in parts
            ]
            sums = FixedOrderSum.build(np.concatenate(targets), part.span, device)
            self.ct_rounds_r.append((em, parts, sums))

        # exchange: irregular groups (raw values), then one import per axis
        self.irr_r = None
        if len(t["irr_buckets"]):
            ix, bk = ExtIndex(part), []
            for slots, out, grp in t["irr_buckets"]:
                sel = part.own(out)
                groups, grp_l = np.unique(grp[sel], return_inverse=True)
                gs = np.asarray(slots)[groups]
                ix.add(gs)
                bk.append((gs, out[sel] - lo, grp_l))
            em = ix.finish(comm, device)
            self.irr_r = (em, [(idx(em(gs)), idx(o), idx(g)) for gs, o, g in bk])
        self._build_axes(t, meta, fmt, device, dtype)

    def _build_axes(self, t, meta, fmt, device, dtype) -> None:
        part, comm = self.part, self.comm
        S, K, n1 = self.S, self.K, self.n1
        NP_g, NS_g = meta["NP"], meta["NS"]
        nbr = np.where(np.asarray(t["nbr_mask"]) > 0, t["nbr"], -1)
        snbr = np.where(np.asarray(t["snbr_mask"]) > 0, t["snbr"], -1)
        P = np.arange(part.p_lo, part.p_lo + part.pps)
        Sg = np.arange(part.s_lo, part.s_lo + part.sps)
        singles_swept = bool(NS_g) and (meta["use_cross"] or meta["use_ssweep"])

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def val(a):
            return to_tensor(np.asarray(a, np.float64), device, dtype)

        self.axes_r = []
        for k in range(3):
            if meta["use_cross"]:
                sax, srow = 3 - k, 2 * (2 - k)
            else:
                sax, srow = k + 1, 2 * k
            planes = _Planes(part)
            if NP_g:
                planes.add("p", 1, nbr[2 * k][P], part.own_patch)
                planes.add("p", 0, nbr[2 * k + 1][P], part.own_patch)
            if singles_swept:
                planes.add("s", 1, snbr[srow][Sg], part.own_single)
                planes.add("s", 0, snbr[srow + 1][Sg], part.own_single)
            cross = []
            for side_p in (0, 1):
                tbl = (t["cross"] or (None,) * 6)[2 * k + side_p] if meta["use_cross"] else None
                if tbl is None:
                    cross.append(None)
                    continue
                ppos, sidx = np.asarray(tbl[0]), np.asarray(tbl[1])
                pidx, blk = ppos // (K * K), ppos % (K * K)
                zsel = part.own_patch(pidx)
                ssel = part.own_single(sidx)
                planes.add("s", 1 - side_p, sidx[zsel], part.own_single)
                planes.add("p", side_p, pidx[ssel], part.own_patch)
                cross.append((zsel, ssel, pidx, blk, sidx))
            imp, keys, maps = planes.finish(comm, fmt, {"p": k + 1, "s": sax}, n1, device)
            step = {"imp": imp, "keys": keys, "sax": sax}
            if NP_g:
                step["p_lo_nbr"] = idx(_ext_items(maps, ("p", 1), nbr[2 * k][P]))
                step["p_hi_nbr"] = idx(_ext_items(maps, ("p", 0), nbr[2 * k + 1][P]))
                step["p_masks"] = (val(t["nbr_mask"][2 * k][P]).view(-1, 1, 1),
                                   val(t["nbr_mask"][2 * k + 1][P]).view(-1, 1, 1))
            if singles_swept:
                step["s_lo_nbr"] = idx(_ext_items(maps, ("s", 1), snbr[srow][Sg]))
                step["s_hi_nbr"] = idx(_ext_items(maps, ("s", 0), snbr[srow + 1][Sg]))
                step["s_masks"] = (val(t["snbr_mask"][srow][Sg]).view(-1, 1, 1),
                                   val(t["snbr_mask"][srow + 1][Sg]).view(-1, 1, 1))
            step["cross"] = []
            for side_p, c in enumerate(cross):
                if c is None:
                    step["cross"].append(None)
                    continue
                zsel, ssel, pidx, blk, sidx = c
                # Z: own patches read singleton planes (side 1 - side_p)
                zpos = (pidx[zsel] - part.p_lo) * K * K + blk[zsel]
                zsrc = _ext_items(maps, ("s", 1 - side_p), sidx[zsel])
                # reverse: own singletons read patch planes (side side_p)
                prow, pinv = np.unique(pidx[ssel], return_inverse=True)
                spos = pinv * K * K + blk[ssel]
                psrc = _ext_items(maps, ("p", side_p), prow)
                csum = FixedOrderSum.build(sidx[ssel] - part.s_lo, part.sps, device)
                step["cross"].append((idx(zpos), idx(zsrc), idx(psrc), idx(spos), csum))
            self.axes_r.append(step)

    # ------------------------------------------------------------- apply
    def own(self, a):
        """The rank's span of a host array in the level's global slot layout."""
        return self.part.slice(a)

    def allsum(self, partial: torch.Tensor) -> torch.Tensor:
        return self.comm.allsum(partial.reshape(-1)).reshape(partial.shape)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.allsum(torch.sum(x * self.owner * y))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole device-major slot vector (every rank's span, in order)."""
        return self.comm.all_gather(x).reshape(-1)

    def to_global(self, x: torch.Tensor) -> torch.Tensor:
        rep = torch.as_tensor(self.fmt.rep_slot, dtype=torch.int64, device=x.device)
        return self.gather(x)[rep]

    def apply_c(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.dirichlet_keep
        if self.c_node is not None:
            em, slots, src, M, w = self.c_node
            vals = (w * em.extend(x)[M]).sum(-1)
            x[slots] = vals[src]
        if self.sf_levels:
            E1 = self.sf_E1
            for em, parts, (slots, pick) in self.c_rounds_r:
                xe = em.extend(x)
                vals_ = []
                for kind, src, *ab in parts:
                    sv = xe[src]
                    if kind == "p":
                        plane = torch.einsum(
                            "nsj,is->nij", torch.einsum("nst,jt->nsj", sv, E1), E1
                        )
                    else:
                        Ea, Eb = self.sf_Eh[ab[0]], self.sf_Eh[ab[1]]
                        tmp = torch.einsum("nmk,njk->nmj", sv, Eb)
                        plane = torch.einsum("nmj,nim->nij", tmp, Ea)
                    vals_.append(plane.reshape(-1))
                x[slots] = torch.cat(vals_)[pick]
            x = x * self.dirichlet_keep
        return x

    def apply_ct_faces(self, r: torch.Tensor) -> torch.Tensor:
        if not self.sf_levels:
            return r
        E1 = self.sf_E1
        for em, parts, sums in self.ct_rounds_r:
            re = em.extend(r)
            vals_ = []
            for kind, face, mask, *ab in parts:
                plane = re[face] * mask
                if kind == "p":
                    tmp = torch.einsum("nij,is->nsj", plane, E1)
                    contrib = torch.einsum("nsj,jt->nst", tmp, E1)
                else:
                    Ea, Eb = self.sf_Eh[ab[0]], self.sf_Eh[ab[1]]
                    tmp = torch.einsum("nij,nim->nmj", plane, Ea)
                    contrib = torch.einsum("nmj,njk->nmk", tmp, Eb)
                vals_.append(contrib.reshape(-1))
            r = sums.add_into(r.clone(), torch.cat(vals_))
        return r * self.sf_slave_keep

    def exchange_(self, r: torch.Tensor) -> torch.Tensor:
        """The exchange in place on the rank's span ``r``: the torch chain
        with its ghost imports, whatever the device and dtype."""
        sums = None
        if self.irr_r is not None:
            em, bk = self.irr_r
            re = em.extend(r)
            sums = [(re[slots].sum(-1), out, grp) for slots, out, grp in bk]
        S, n1, K = self.S, self.n1, self.K
        up = self._patches(r) if self.NP else None
        us = self._singles(r).view(self.NS, n1, n1, n1) if self.NS else None
        for k, step in enumerate(self.axes_r):
            ghost = step["imp"](r)
            pieces, at = {}, 0
            for bucket, side, n_items, n in step["keys"]:
                pieces[(bucket, side)] = ghost[at : at + n_items * n * n].view(n_items, n, n)
                at += n_items * n * n
            adds = {}
            if "p_lo_nbr" in step:
                p_lo, p_hi = up.select(k + 1, 0), up.select(k + 1, S - 1)
                P0 = torch.cat([p_lo, pieces[("p", 0)]])
                P1 = torch.cat([p_hi, pieces[("p", 1)]])
                m_lo, m_hi = step["p_masks"]
                adds["plo"] = P1[step["p_lo_nbr"]] * m_lo
                adds["phi"] = P0[step["p_hi_nbr"]] * m_hi
            if "s_lo_nbr" in step:
                sax = step["sax"]
                s_lo, s_hi = us.select(sax, 0), us.select(sax, n1 - 1)
                S0 = torch.cat([s_lo, pieces[("s", 0)]])
                S1 = torch.cat([s_hi, pieces[("s", 1)]])
                m_lo, m_hi = step["s_masks"]
                adds["slo"] = S1[step["s_lo_nbr"]] * m_lo
                adds["shi"] = S0[step["s_hi_nbr"]] * m_hi
            for side_p, c in enumerate(step["cross"]):
                if c is None:
                    continue
                zpos, zsrc, psrc, spos, csum = c
                spre, ppre = (S1, P0) if side_p == 0 else (S0, P1)
                E = self.Easm
                sp = spre[zsrc].transpose(1, 2)
                grid = torch.zeros((self.NP * K * K, n1, n1), dtype=r.dtype, device=r.device)
                grid[zpos] = sp
                Gm = (
                    grid.view(self.NP, K, K, n1, n1)
                    .permute(0, 1, 3, 2, 4)
                    .reshape(self.NP, K * n1, K * n1)
                )
                Z = torch.einsum("su,puv,tv->pst", E, Gm, E)
                pp = ppre[psrc]
                Gi = torch.einsum("su,pst,tv->puv", E, pp, E)
                sub = (
                    Gi.view(len(pp), K, n1, K, n1)
                    .permute(0, 1, 3, 2, 4)
                    .reshape(len(pp) * K * K, n1, n1)[spos]
                )
                subT = sub.transpose(1, 2)
                if side_p == 0:
                    adds["plo"] = adds["plo"] + Z
                    adds["shi"] = csum.add_into(adds["shi"], subT)
                else:
                    adds["phi"] = adds["phi"] + Z
                    adds["slo"] = csum.add_into(adds["slo"], subT)
            if "plo" in adds:
                p_lo.add_(adds["plo"])
                p_hi.add_(adds["phi"])
            if "slo" in adds:
                s_lo.add_(adds["slo"])
                s_hi.add_(adds["shi"])
        if sums is not None:
            r[torch.cat([o for _, o, _ in sums])] = torch.cat([s[g] for s, _, g in sums])
        return r

    def apply_ct(self, r: torch.Tensor) -> torch.Tensor:
        if self.ct_node is not None:
            em, reps, src, ct_sum, w, refresh = self.ct_node
            vals = em.extend(r)[reps]
            r = r * self.slave_keep
            ct_sum.add_into(r, w * vals[src])
            if refresh is not None:
                em2, slots, src2 = refresh
                r[slots] = em2.extend(r)[src2]
        return r * self.dirichlet_keep


# ---------------------------------------------------------------------------
# transfers between two levels whose partitions differ
# ---------------------------------------------------------------------------


class _Tables:
    """One direction's transfer tables on this rank (the attributes the
    cores of ops/hybrid_transfer.py read)."""

    _interp_sub = HybridTransfer._interp_sub
    _interp_sub_t = HybridTransfer._interp_sub_t

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _item_map(part_lo: int, n_own: int, ghosts: np.ndarray, ids, pad: int | None = None):
    """Item ids (patches or singletons of one level) -> rows of the stack
    ``[own | ghosts]``; ids equal to ``pad`` map to the row after it."""
    ids = np.asarray(ids, np.int64)
    out = np.empty(ids.shape, np.int64)
    own = (ids >= part_lo) & (ids < part_lo + n_own)
    out[own] = ids[own] - part_lo
    rest = ~own
    if pad is not None:
        padded = ids == pad
        out[padded] = n_own + len(ghosts)
        rest &= ~padded
    if rest.any():
        pos = np.searchsorted(ghosts, ids[rest])
        assert (ghosts[np.minimum(pos, len(ghosts) - 1)] == ids[rest]).all()
        out[rest] = n_own + pos
    return out


def _whole_slots(fmt, patches, singles) -> np.ndarray:
    """Every slot of the given patches, then of the given singletons."""
    S3, nloc = fmt.S**3, fmt.dofh.n_loc
    a = (fmt.patch_slot_base(patches)[:, None] + np.arange(S3)).reshape(-1)
    b = (fmt.single_slot_base(singles)[:, None] + np.arange(nloc)).reshape(-1)
    return np.concatenate([a, b]).astype(np.int64)


class RankHybridTransfer:
    """Prolongation and restriction between two hybrid levels, at least one
    of them device-major, on one rank (ops/hybrid_transfer.py's algorithm
    restricted to the rank's outputs).

    Prolongation: the rank computes its fine patches and singletons; the
    coarse patches, singleton rows and slots they read on other ranks come
    first, in one import.  Restriction: the rank computes its coarse slots
    (the owner computes); the masked fine patches and singletons they read
    on other ranks come in one import, and the slot-table scatters sum the
    one-device table's sources for the rank's targets in that table's
    order.  A replicated level is owned whole by every rank: restricting
    into one reads every fine contribution on every rank, and every rank
    then sums them in the same fixed order, so the coarse vector is
    identical on every rank.  Imports are proportional to where the two
    levels' partitions disagree."""

    def __init__(self, tables, meta, fine_fmt, coarse_fmt, fine_op, coarse_op,
                 ls_mode, device, dtype, comm):
        self.coarse_op, self.fine_op, self.ls_mode, self.comm = coarse_op, fine_op, ls_mode, comm
        pf, pc = SlotPart.of(fine_fmt, comm.rank), SlotPart.of(coarse_fmt, comm.rank)
        self.pf, self.pc = pf, pc
        self.S_f, self.S_c = meta["S_f"], meta["S_c"]
        self.nloc_f, self.nloc_c = fine_fmt.dofh.n_loc, coarse_fmt.dofh.n_loc
        self.coarse_has_patches = coarse_fmt.n_patches > 0
        self.fine_has_patches = fine_fmt.n_patches > 0

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def val(a):
            return to_tensor(np.asarray(a, np.float64), device, dtype)

        E1 = val(tables["E1"])
        common = dict(
            E1=E1, S_c=self.S_c, S_f=self.S_f, sub=meta["sub"], nloc_f=self.nloc_f,
            patch_offsets=meta["patch_offsets"], id_oct_offsets=meta["id_oct_offsets"],
            ls_mode=ls_mode, fine_constrained_keep=fine_op.constrained_keep,
        )
        NPc, NPf = coarse_fmt.n_patches, fine_fmt.n_patches

        # ---- prolongation: the fine owner computes -----------------------
        fo_p = pf.own_patch
        gp, gs, loose = [], [], []
        for fidx, cidx, _ch in tables["patch_buckets"]:
            gp.append(cidx[fo_p(fidx)])
        if tables["id_bucket"] is not None:
            fidx, cidx = tables["id_bucket"]
            gp.append(cidx[fo_p(fidx)])
        for src_rows, _fr in tables["id_oct"]:
            own_rows = src_rows[pf.p_lo : pf.p_lo + pf.pps]
            gp.append(own_rows[own_rows < NPc])
        for key in ("irr_patch", "irr_id"):
            if tables[key] is not None:
                fidx, slots = tables[key]
                loose.append(slots[fo_p(fidx)].reshape(-1))
        fo_s = pf.own_single
        for sidx, slots, _M in tables["single_buckets"]:
            loose.append(slots[fo_s(sidx)].reshape(-1))
        for sidx, crow, _M in tables["single_fast"]:
            gs.append(crow[fo_s(sidx)])

        def remote(items, own):
            items = np.unique(np.concatenate(items)) if items else np.zeros(0, np.int64)
            return items[~own(items)]

        gp_c = remote(gp, pc.own_patch)
        gs_c = remote(gs, pc.own_single)
        loose = np.concatenate(loose) if loose else np.zeros(0, np.int64)
        loose = np.unique(loose[(loose < pc.n_slots) & ~pc.own(loose)])
        whole = _whole_slots(coarse_fmt, gp_c, gs_c)
        self.p_imp = GhostImport.build(
            comm if pc.sharded else None, pc, np.concatenate([whole, loose]), device
        )
        self.p_split = (len(gp_c), len(gs_c))
        loose_base = pc.span + len(whole)

        def cslot_ext(g):
            g = np.asarray(g, np.int64)
            out = np.full(g.shape, pc.span + len(whole) + len(loose), np.int64)  # trailing 0
            own = pc.own(g)
            out[own] = g[own] - pc.lo
            rem = ~own & (g < pc.n_slots)
            if rem.any():
                pos = np.searchsorted(loose, g[rem])
                out[rem] = loose_base + pos
            return out

        def cpatch(ids, pad=None):
            return _item_map(pc.p_lo, pc.pps, gp_c, ids, pad)

        def csingle(ids):
            return _item_map(pc.s_lo, pc.sps, gs_c, ids)

        pb = []
        for fidx, cidx, _ch in tables["patch_buckets"]:
            sel = fo_p(fidx)
            pb.append((idx(fidx[sel] - pf.p_lo), idx(cpatch(cidx[sel])), None))
        idb = None
        if tables["id_bucket"] is not None:
            fidx, cidx = tables["id_bucket"]
            sel = fo_p(fidx)
            idb = (idx(fidx[sel] - pf.p_lo), idx(cpatch(cidx[sel])))
        ido = tuple(
            (idx(cpatch(src_rows[pf.p_lo : pf.p_lo + pf.pps], pad=NPc)), None)
            for src_rows, _fr in tables["id_oct"]
        )

        def rows_p(key):
            if tables[key] is None:
                return None
            fidx, slots = tables[key]
            sel = fo_p(fidx)
            return (idx(fidx[sel] - pf.p_lo), idx(cslot_ext(slots[sel])))

        self.P = _Tables(
            **common,
            NP_f=pf.pps, NS_f=pf.sps, n_slots_f=pf.span,
            patch_buckets=tuple(pb), id_bucket=idb, id_oct=ido,
            irr_patch=rows_p("irr_patch"), irr_id=rows_p("irr_id"),
            single_buckets=tuple(
                (idx(s[fo_s(s)] - pf.s_lo), idx(cslot_ext(sl[fo_s(s)])), val(M))
                for s, sl, M in tables["single_buckets"]
            ),
            single_fast=tuple(
                (idx(s[fo_s(s)] - pf.s_lo), idx(csingle(c[fo_s(s)])), val(M))
                for s, c, M in tables["single_fast"]
            ),
        )

        # ---- restriction: the coarse owner computes ------------------------
        co_p = pc.own_patch
        fp, fs = [], []
        pbr = []
        for fidx, cidx, _ch in tables["patch_buckets"]:
            sel = co_p(cidx)
            fp.append(fidx[sel])
            rows = np.full(pc.pps, int(sel.sum()), np.int64)
            rows[cidx[sel] - pc.p_lo] = np.arange(int(sel.sum()))
            pbr.append((fidx[sel], rows))
        idr = None
        if tables["id_bucket"] is not None:
            fidx, cidx = tables["id_bucket"]
            sel = co_p(cidx)
            fp.append(fidx[sel])
            idr = (fidx[sel], cidx[sel] - pc.p_lo)
        idor = []
        for _sr, fine_rows in tables["id_oct"]:
            own_rows = fine_rows[pc.p_lo : pc.p_lo + pc.pps]
            fp.append(own_rows[own_rows < NPf])
            idor.append(own_rows)
        single_base_c = coarse_fmt.single_slot_base
        tg = restrict_targets(tables, single_base_c)
        irr_r, at = {}, 0
        for key in ("irr_patch", "irr_id"):
            if tables[key] is not None:
                fidx = tables[key][0]
                t_ = tg[at]
                at += 1
                n = len(fidx)
                sel = pc.own(t_.reshape(n, -1)).any(1) if n else np.zeros(0, bool)
                fp.append(fidx[sel])
                irr_r[key] = (fidx[sel], t_.reshape(n, -1)[sel].reshape(-1))
        sing_r = []
        for (sidx, _s, M) in tuple(tables["single_buckets"]) + tuple(tables["single_fast"]):
            t_ = tg[at]
            at += 1
            n = len(sidx)
            sel = pc.own(t_.reshape(n, -1)).any(1) if n else np.zeros(0, bool)
            fs.append(sidx[sel])
            sing_r.append((sidx[sel], t_.reshape(n, -1)[sel].reshape(-1), M))
        gp_f = remote(fp, pf.own_patch)
        gs_f = remote(fs, pf.own_single)
        self.r_imp = GhostImport.build(
            comm if pf.sharded else None, pf, _whole_slots(fine_fmt, gp_f, gs_f), device
        )
        self.r_split = (len(gp_f), len(gs_f))

        def fpatch(ids, pad=None):
            return _item_map(pf.p_lo, pf.pps, gp_f, ids, pad)

        def fsingle(ids):
            return _item_map(pf.s_lo, pf.sps, gs_f, ids)

        targets = []
        for key in ("irr_patch", "irr_id"):
            if key in irr_r:
                targets.append(irr_r[key][1])
        for _s, t_, _M in sing_r:
            targets.append(t_)
        rsum = None
        if targets:
            tcat = np.concatenate(targets)
            rsum = FixedOrderSum.build(
                np.where(pc.own(tcat), tcat - pc.lo, -1), pc.span, device
            )
        n_sb = len(tables["single_buckets"])
        self.R = _Tables(
            **common,
            NP_f=pf.pps, NS_f=pf.sps,
            patch_buckets=tuple(
                (idx(fpatch(f)), None, idx(rows)) for f, rows in pbr
            ),
            id_bucket=None if idr is None else (idx(fpatch(idr[0])), idx(idr[1])),
            id_oct=tuple((None, idx(fpatch(r, pad=NPf))) for r in idor),
            irr_patch=None if "irr_patch" not in irr_r else (idx(fpatch(irr_r["irr_patch"][0])), None),
            irr_id=None if "irr_id" not in irr_r else (idx(fpatch(irr_r["irr_id"][0])), None),
            single_buckets=tuple((idx(fsingle(s)), None, val(M)) for s, _t, M in sing_r[:n_sb]),
            single_fast=tuple((idx(fsingle(s)), None, val(M)) for s, _t, M in sing_r[n_sb:]),
            restrict_sum=rsum,
        )
        self.fine_owner = fine_op.owner
        self.fine_constrained_keep = fine_op.constrained_keep

    def prolong(self, uc: torch.Tensor) -> torch.Tensor:
        cop = self.coarse_op
        if not self.ls_mode:
            uc = cop.apply_c(uc)
        g = self.p_imp(uc)
        S, nloc = self.S_c, self.nloc_c
        ngp, ngs = self.p_split
        up_c = None
        if self.coarse_has_patches:
            up_c = torch.cat([cop._patches(uc), g[: ngp * S**3].view(ngp, S, S, S)])
        us_c = torch.cat([
            cop._singles(uc).view(-1, nloc),
            g[ngp * S**3 : ngp * S**3 + ngs * nloc].view(ngs, nloc),
        ])
        return _prolong_core(self.P, torch.cat([uc, g, uc.new_zeros(1)]), up_c, us_c)

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        cop = self.coarse_op
        if self.ls_mode:
            rf = rf * self.fine_owner
        else:
            rf = rf * self.fine_constrained_keep * self.fine_owner
        g = self.r_imp(rf)
        S, nloc = self.S_f, self.nloc_f
        ngp, ngs = self.r_split
        nfp = self.pf.pps * S**3
        rp = torch.cat([rf[:nfp].view(-1, S, S, S), g[: ngp * S**3].view(ngp, S, S, S)])
        rs = torch.cat([rf[nfp:].view(-1, nloc), g[ngp * S**3 :].view(ngs, nloc)])
        acc = torch.zeros(self.pc.span, dtype=rf.dtype, device=rf.device)
        _restrict_core(self.R, rp, rs, acc, cop._patches(acc) if self.coarse_has_patches else None)
        return self._restrict_coarse_tail(acc)

    _restrict_coarse_tail = HybridTransfer._restrict_coarse_tail
