"""Device half of the hybrid patch engine: the constrained Laplacian on torch.

``HybridOperator`` holds one level's tables (ops/hybrid_format.py) as
tensors on a device and applies

  1. C (``apply_c``): Dirichlet mask, per-node hanging slaves, then the
     structured hanging faces as E1 plane embeddings in ascending rounds;
  2. the bulk compute (``cell_apply_raw``): the patch stencil kernel
     (ops/patch_stencil.py) on the patch bucket and one element GEMM on the
     singleton bucket;
  3. C^T on structured faces (``apply_ct_faces``, descending rounds);
  4. the assembly exchange (``exchange``): three sequential face-plane
     sweeps (interleaved with the patch<->singleton cross terms on levels
     with ``use_cross``), then the irregular group sums;
  5. per-node C^T (``apply_ct``) and identity on constrained slots.

The algebra is the JAX package's plain path (dealii_multigrid_tpu/ops/
hybrid.py, every TPU layout variant off).  JAX's functional ``.at[]``
updates become in-place writes on tensors this module allocated; every
stage that reads values from before an update computes them first.
Scatter-adds use ``index_add_``, which sums in a run-dependent order on
CUDA.
"""

from __future__ import annotations

import torch

from ..utils.device import to_tensor
from .patch_stencil import patch_stencil


def tables_to_device(tree, device: torch.device, dtype: torch.dtype):
    """Nested tuples / dicts of host arrays -> the same structure of tensors
    (integer arrays as int64 indices, float arrays as ``dtype``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tables_to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tables_to_device(v, device, dtype) for v in tree)
    return to_tensor(tree, device, dtype)


class HybridOperator:
    """Constrained Laplacian in the hybrid slot layout, on one device."""

    #: device tables (the JAX HybridOperator's data fields of the plain path)
    TABLE_KEYS = (
        "KS", "MS", "elem", "pscale", "sscale", "nbr", "nbr_mask", "snbr",
        "snbr_mask", "irr_buckets", "dirichlet_keep", "slave_keep",
        "constrained_keep", "slave_master_slots", "slave_w", "slave_all_slots",
        "slave_all_src", "slave_rep", "ct_target", "ct_src", "ct_w",
        "refresh_slots", "refresh_src", "owner", "sf_patch", "sf_single",
        "sf_patch_rows", "sf_E1", "sf_slave_keep", "sf_Eh", "cross", "Easm",
    )
    #: static metadata (the JAX HybridOperator's meta fields of the plain path)
    META_KEYS = (
        "use_ssweep", "use_cross", "NP", "NS", "S", "nloc", "n_slots", "n_dofs",
        "sf_levels", "sf_patch_rows_meta", "sf_c_rounds", "sf_ct_rounds",
    )

    def __init__(self, t: dict, meta: dict, device: torch.device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        for k, v in meta.items():
            setattr(self, k, v)
        for k, v in t.items():
            setattr(self, k, v)
        self.n1 = round(self.nloc ** (1 / 3))
        self.K = (self.S - 1) // max(self.n1 - 1, 1)
        self.patch_slots = self.NP * self.S**3

    @classmethod
    def from_arrays(
        cls, tables: dict, meta: dict, device: torch.device, dtype: torch.dtype
    ) -> "HybridOperator":
        """Build from host tables (``hybrid_operator_tables`` or the JAX
        operator's data leaves as NumPy arrays, same keys)."""
        return cls(tables_to_device(tables, device, dtype), meta, device, dtype)

    # ------------------------------------------------------- bucket views
    def _patches(self, x: torch.Tensor) -> torch.Tensor:
        S = self.S
        return x[: self.patch_slots].view(self.NP, S, S, S)

    def _singles(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.patch_slots :].view(self.NS, self.nloc)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Ownership-masked dot: each global DoF counted once."""
        return torch.sum(x * self.owner * y)

    # -------------------------------------------------------- constraints
    def apply_c(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.dirichlet_keep
        if self.slave_rep.shape[0]:
            vals = (self.slave_w * x[self.slave_master_slots]).sum(-1)
            x[self.slave_all_slots] = vals[self.slave_all_src]
        if self.sf_levels:
            E1 = self.sf_E1
            # fine levels ASCENDING, one combined scatter-set per round (the
            # rounds are proven chain-free at build time); a round's values
            # are all read before its write
            rounds = self.sf_c_rounds or tuple(
                (i,) for i in range(len(self.sf_levels))
            )
            for rnd in rounds:
                idxs, vals_ = [], []
                for i in rnd:
                    if self.sf_patch[i] is not None:
                        face, src, _m = self.sf_patch[i]
                        sv = x[src]                                  # [n, sub, sub]
                        plane = torch.einsum(
                            "nsj,is->nij", torch.einsum("nst,jt->nsj", sv, E1), E1
                        )
                        idxs.append(face.reshape(-1))
                        vals_.append(plane.reshape(-1))
                    if self.sf_single[i] is not None:
                        face, src, _m, pa, pb = self.sf_single[i]
                        Ea, Eb = self.sf_Eh[pa], self.sf_Eh[pb]      # [n, n1, n1]
                        sv = x[src]
                        tmp = torch.einsum("nmk,njk->nmj", sv, Eb)
                        plane = torch.einsum("nmj,nim->nij", tmp, Ea)
                        idxs.append(face.reshape(-1))
                        vals_.append(plane.reshape(-1))
                # duplicate indices (slots on two covered faces) receive
                # equal values, so an unordered scatter-set is well-defined
                if idxs:
                    x[torch.cat(idxs)] = torch.cat(vals_)
            x = x * self.dirichlet_keep
        return x

    def apply_ct_faces(self, r: torch.Tensor) -> torch.Tensor:
        """Structured C^T on RAW residuals (before exchange): ship masked fine
        face planes to the coarse quarter-planes, zero the structured slaves."""
        if not self.sf_levels:
            return r
        rounds = self.sf_ct_rounds or tuple(
            (i,) for i in range(len(self.sf_levels) - 1, -1, -1)
        )
        for rnd in rounds:
            idxs, vals_ = [], []
            for i in rnd:
                self._ct_faces_level(r, i, idxs, vals_)
            r = r.index_add(0, torch.cat(idxs), torch.cat(vals_))
        return r * self.sf_slave_keep

    def _ct_faces_level(self, r, i, idxs, vals_) -> None:
        """Collect one level's C^T face contributions (reads + GEMMs only)."""
        E1 = self.sf_E1
        if self.sf_patch[i] is not None:
            _face, src, mask = self.sf_patch[i]
            rp = self._patches(r)
            plane = torch.cat(
                [
                    rp.select(d + 1, (self.S - 1) if side else 0)[fidx]
                    for fidx, (d, side, _c) in zip(
                        self.sf_patch_rows[i], self.sf_patch_rows_meta[i]
                    )
                ]
            ) * mask
            tmp = torch.einsum("nij,is->nsj", plane, E1)
            contrib = torch.einsum("nsj,jt->nst", tmp, E1)
            idxs.append(src.reshape(-1))
            vals_.append(contrib.reshape(-1))
        if self.sf_single[i] is not None:
            face, src, mask, pa, pb = self.sf_single[i]
            Ea, Eb = self.sf_Eh[pa], self.sf_Eh[pb]
            plane = r[face] * mask
            tmp = torch.einsum("nij,nim->nmj", plane, Ea)
            contrib = torch.einsum("nmj,njk->nmk", tmp, Eb)
            idxs.append(src.reshape(-1))
            vals_.append(contrib.reshape(-1))

    def apply_ct(self, r: torch.Tensor) -> torch.Tensor:
        if self.slave_rep.shape[0]:
            vals = r[self.slave_rep]
            r = r * self.slave_keep
            r.index_add_(0, self.ct_target, self.ct_w * vals[self.ct_src])
            # broadcast master rep values to their duplicate slots (the two
            # index sets are disjoint)
            if self.refresh_slots.shape[0]:
                r[self.refresh_slots] = r[self.refresh_src]
        return r * self.dirichlet_keep

    # ----------------------------------------------------------- exchange
    @staticmethod
    def _sweeps(up: torch.Tensor, nbr, nbr_mask, S: int) -> None:
        """In place: three sequential face-plane sweeps over a bucket
        ``[n, S, S, S]``; each axis reads its planes before writing them."""
        for d in range(3):
            axis = d + 1
            top = up.select(axis, S - 1)
            bot = up.select(axis, 0)
            add_lo = top[nbr[2 * d]] * nbr_mask[2 * d].view(-1, 1, 1)
            add_hi = bot[nbr[2 * d + 1]] * nbr_mask[2 * d + 1].view(-1, 1, 1)
            bot.add_(add_lo)
            top.add_(add_hi)

    def _exchange_cross(self, r: torch.Tensor) -> None:
        """In place on ``r``: per geometric axis, patch sweeps, singleton
        sweeps AND patch<->singleton cross terms, all adds within an axis
        computed from pre-axis values (host mirror: _simulate_full)."""
        S, n1, K = self.S, self.n1, self.K
        NP, NS = self.NP, self.NS
        E = self.Easm
        up = self._patches(r)
        us = self._singles(r).view(NS, n1, n1, n1)
        for g in range(3):
            sax = 3 - g
            p_lo, p_hi = up.select(g + 1, 0), up.select(g + 1, S - 1)
            s_lo, s_hi = us.select(sax, 0), us.select(sax, n1 - 1)
            add_plo = p_hi[self.nbr[2 * g]] * self.nbr_mask[2 * g].view(-1, 1, 1)
            add_phi = p_lo[self.nbr[2 * g + 1]] * self.nbr_mask[2 * g + 1].view(-1, 1, 1)
            ds = 2 - g  # snbr tables are lattice-axis ([z, y, x]) ordered
            add_slo = s_hi[self.snbr[2 * ds]] * self.snbr_mask[2 * ds].view(-1, 1, 1)
            add_shi = s_lo[self.snbr[2 * ds + 1]] * self.snbr_mask[2 * ds + 1].view(-1, 1, 1)
            for side_p in (0, 1):
                tbl = self.cross[2 * g + side_p]
                if tbl is None:
                    continue
                ppos, sidx = tbl
                ppre, spre = (p_lo, s_hi) if side_p == 0 else (p_hi, s_lo)
                # singleton planes [m, n1, n1] -> dense patch-face grid ->
                # overlap-assembled [NP, S, S] via two small GEMMs
                sp = spre[sidx].transpose(1, 2)
                grid = torch.zeros((NP * K * K, n1, n1), dtype=r.dtype, device=r.device)
                grid[ppos] = sp
                Gm = (
                    grid.view(NP, K, K, n1, n1)
                    .permute(0, 1, 3, 2, 4)
                    .reshape(NP, K * n1, K * n1)
                )
                Z = torch.einsum("su,puv,tv->pst", E, Gm, E)
                # reverse: extract the n1 x n1 subblocks of the patch face
                Gi = torch.einsum("su,pst,tv->puv", E, ppre, E)
                sub = (
                    Gi.view(NP, K, n1, K, n1)
                    .permute(0, 1, 3, 2, 4)
                    .reshape(NP * K * K, n1, n1)[ppos]
                )
                subT = sub.transpose(1, 2)
                if side_p == 0:
                    add_plo = add_plo + Z
                    add_shi = add_shi.index_add(0, sidx, subT)
                else:
                    add_phi = add_phi + Z
                    add_slo = add_slo.index_add(0, sidx, subT)
            p_lo.add_(add_plo)
            p_hi.add_(add_phi)
            s_lo.add_(add_slo)
            s_hi.add_(add_shi)

    def exchange(self, r: torch.Tensor) -> torch.Tensor:
        """Sum duplicated slots: irregular group sums (from raw values), then
        structured plane sweeps, then overwrite the irregular slots."""
        sums = [r[slots].sum(-1) for slots, _, _ in self.irr_buckets]
        r = r.clone()
        if self.use_cross:
            self._exchange_cross(r)
        else:
            if self.NP:
                self._sweeps(self._patches(r), self.nbr, self.nbr_mask, self.S)
            if self.NS and self.use_ssweep:
                n1 = self.n1
                us = self._singles(r).view(self.NS, n1, n1, n1)
                self._sweeps(us, self.snbr, self.snbr_mask, n1)
        if sums:
            # ONE combined scatter for all size buckets (their dofs are disjoint)
            out_all = torch.cat([b[1] for b in self.irr_buckets])
            val_all = torch.cat([s[b[2]] for b, s in zip(self.irr_buckets, sums)])
            r[out_all] = val_all
        return r

    # -------------------------------------------------------------- apply
    def cell_apply_raw(self, x: torch.Tensor) -> torch.Tensor:
        """Per-patch stencil (the CUDA kernel on the card) + per-singleton
        element GEMM; the result is pre-exchange."""
        parts = []
        if self.NP:
            xp = x[: self.patch_slots].view(self.NP, self.S**3)
            parts.append(patch_stencil(xp, self.KS, self.MS, self.pscale).reshape(-1))
        if self.NS:
            rs = torch.matmul(self._singles(x), self.elem) * self.sscale[:, None]
            parts.append(rs.reshape(-1))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        r = self.cell_apply_raw(self.apply_c(x))
        r = self.apply_ct_faces(r)
        r = self.exchange(r)
        r = self.apply_ct(r)
        # identity on constrained DoFs (reference operator.h:152-183)
        return r * self.constrained_keep + x * (1.0 - self.constrained_keep)


def make_hybrid_operator(fmt, hanging, device, dtype) -> HybridOperator:
    """Host tables (hybrid_format.hybrid_operator_tables) -> device operator."""
    from .hybrid_format import hybrid_operator_tables

    tables, meta = hybrid_operator_tables(fmt, hanging)
    return HybridOperator.from_arrays(tables, meta, device, dtype)

