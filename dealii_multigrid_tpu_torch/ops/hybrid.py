"""Device half of the hybrid patch engine: the constrained Laplacian on torch.

``HybridOperator`` holds one level's tables (ops/hybrid_format.py) as
tensors on a device and applies

  1. C (``apply_c``): Dirichlet mask, per-node hanging slaves, then the
     structured hanging faces as E1 plane embeddings in ascending rounds;
  2. the bulk compute (``cell_apply_raw``): the patch stencil kernel
     (ops/patch_stencil.py) on the patch bucket and one element GEMM on the
     singleton bucket;
  3. C^T on structured faces (``apply_ct_faces``, descending rounds);
  4. the assembly exchange (``exchange_``, in place; ops/
     assembly_exchange.py): three sequential face-plane sweeps
     (interleaved with the patch<->singleton cross terms on levels with
     ``use_cross``), then the irregular group sums, one kernel launch per
     sweep axis on the card;
  5. per-node C^T (``apply_ct``) and identity on constrained slots
     (``vmult_split`` returns the result before this blend).

The algebra is the JAX package's plain path (dealii_multigrid_tpu/ops/
hybrid.py, every TPU layout variant off).  JAX's functional ``.at[]``
updates become in-place writes on tensors this module allocated; every
stage that reads values from before an update computes them first.
Scatter-adds with duplicate targets are fixed-order gathers
(ops/fixed_order.py), and a scatter-set whose duplicate targets get values
equal only up to roundoff keeps one writer per target; both are built on
the host from the index tables, so a float32 apply is bit-repeatable on
CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import to_tensor
from ..utils.phases import PREFIX, setup_span, spanned
from . import assembly_exchange
from .fixed_order import FixedOrderSum
from .patch_stencil import matrix_band, patch_stencil

# the parts of an operator application, as profiler ranges (utils/phases.py)
APPLY_C = PREFIX + "operator.apply_c"
CELL_APPLY = PREFIX + "operator.cell_apply"
APPLY_CT_FACES = PREFIX + "operator.apply_ct_faces"
EXCHANGE = PREFIX + "operator.exchange"
APPLY_CT = PREFIX + "operator.apply_ct"


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
    #: the host layout the tables were built from (make_hybrid_operator sets
    #: it; the phase profilers draw consistent vectors through it)
    fmt = None

    def __init__(
        self, t: dict, meta: dict, device: torch.device, dtype: torch.dtype, band: int
    ):
        self.device = torch.device(device)
        self.dtype = dtype
        #: half-width of KS and MS (the stencil kernel's template argument)
        self.band = band
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
        operator's data leaves as NumPy arrays, same keys).  The band of KS
        and MS and the fixed-order sum tables are made here, on the host,
        once."""
        band = matrix_band(tables["KS"], tables["MS"])
        op = cls(tables_to_device(tables, device, dtype), meta, device, dtype, band)
        op._build_sums(tables, meta)
        if op.device.type == "cuda":
            op.exchange_plan = assembly_exchange.ExchangePlan.build(tables, meta).to(op.device)
        return op

    def _build_sums(self, t: dict, meta: dict) -> None:
        """Fixed-order tables of the three scatter-adds: per-node C^T
        (``ct_sum``), each structured C^T round (``ct_face_sums``) and each
        patch<->singleton cross table (``cross_sums``); and one writer per
        slot for each structured C round (``c_round_writes``)."""
        n, dev = meta["n_slots"], self.device
        self.ct_sum = FixedOrderSum.build(t["ct_target"], n, dev)
        c_rounds = meta["sf_c_rounds"] or tuple((i,) for i in range(len(meta["sf_levels"])))
        self.c_round_writes = tuple(
            _last_writers(np.concatenate([
                np.asarray(part[0]).reshape(-1)
                for i in rnd
                for part in (t["sf_patch"][i], t["sf_single"][i])
                if part is not None
            ]), dev)
            for rnd in c_rounds
        )
        rounds = meta["sf_ct_rounds"] or tuple(
            (i,) for i in range(len(meta["sf_levels"]) - 1, -1, -1)
        )
        self.ct_face_sums = tuple(
            FixedOrderSum.build(
                np.concatenate([
                    np.asarray(part[1]).reshape(-1)
                    for i in rnd
                    for part in (t["sf_patch"][i], t["sf_single"][i])
                    if part is not None
                ]),
                n, dev,
            )
            for rnd in rounds
        )
        self.cross_sums = tuple(
            None if tbl is None else FixedOrderSum.build(tbl[1], meta["NS"], dev)
            for tbl in (t["cross"] or (None,) * 6)
        )

    def sum_tables(self) -> dict:
        """name -> FixedOrderSum of this operator's scatter-adds."""
        out = {"ct": self.ct_sum}
        out.update({f"ct_faces{i}": s for i, s in enumerate(self.ct_face_sums)})
        out.update({f"cross{i}": s for i, s in enumerate(self.cross_sums) if s is not None})
        return out

    # ------------------------------------------------------- bucket views
    def _patches(self, x: torch.Tensor) -> torch.Tensor:
        S = self.S
        return x[: self.patch_slots].view(self.NP, S, S, S)

    def _singles(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.patch_slots :].view(self.NS, self.nloc)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Ownership-masked dot: each global DoF counted once."""
        return torch.sum(x * self.owner * y)

    # ------------------------------------ one device (a rank's span: hybrid_rank.py)
    def own(self, a):
        """This device's part of a host array in the level's slot layout."""
        return a

    def allsum(self, partial: torch.Tensor) -> torch.Tensor:
        """The sum of ``partial`` over the devices sharing the level."""
        return partial

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole slot vector."""
        return x

    def to_global(self, x: torch.Tensor) -> torch.Tensor:
        """Slot vector -> global DoF vector (one representative slot each)."""
        rep = torch.as_tensor(self.fmt.rep_slot, dtype=torch.int64, device=x.device)
        return x[rep]

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
            for rnd, (slots, pick) in zip(rounds, self.c_round_writes):
                vals_ = []
                for i in rnd:
                    if self.sf_patch[i] is not None:
                        _face, src, _m = self.sf_patch[i]
                        sv = x[src]                                  # [n, sub, sub]
                        plane = torch.einsum(
                            "nsj,is->nij", torch.einsum("nst,jt->nsj", sv, E1), E1
                        )
                        vals_.append(plane.reshape(-1))
                    if self.sf_single[i] is not None:
                        _face, src, _m, pa, pb = self.sf_single[i]
                        Ea, Eb = self.sf_Eh[pa], self.sf_Eh[pb]      # [n, n1, n1]
                        sv = x[src]
                        tmp = torch.einsum("nmk,njk->nmj", sv, Eb)
                        plane = torch.einsum("nmj,nim->nij", tmp, Ea)
                        vals_.append(plane.reshape(-1))
                # a slot on two covered faces gets two values, equal up to
                # roundoff; the round's last writer of each slot writes it
                # (what a sequential scatter does), so that an unordered
                # CUDA scatter cannot pick one at random
                if vals_:
                    x[slots] = torch.cat(vals_)[pick]
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
        for rnd, sums in zip(rounds, self.ct_face_sums):
            vals_ = []
            for i in rnd:
                self._ct_faces_level(r, i, vals_)
            r = sums.add_into(r.clone(), torch.cat(vals_))
        return r * self.sf_slave_keep

    def _ct_faces_level(self, r, i, vals_) -> None:
        """Collect one level's C^T face contributions (reads + GEMMs only),
        in the order of the round's sum table: patch faces, then singles."""
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
            vals_.append(contrib.reshape(-1))
        if self.sf_single[i] is not None:
            face, src, mask, pa, pb = self.sf_single[i]
            Ea, Eb = self.sf_Eh[pa], self.sf_Eh[pb]
            plane = r[face] * mask
            tmp = torch.einsum("nij,nim->nmj", plane, Ea)
            contrib = torch.einsum("nmj,njk->nmk", tmp, Eb)
            vals_.append(contrib.reshape(-1))

    def apply_ct(self, r: torch.Tensor) -> torch.Tensor:
        if self.slave_rep.shape[0]:
            vals = r[self.slave_rep]
            r = r * self.slave_keep
            self.ct_sum.add_into(r, self.ct_w * vals[self.ct_src])
            # broadcast master rep values to their duplicate slots (the two
            # index sets are disjoint)
            if self.refresh_slots.shape[0]:
                r[self.refresh_slots] = r[self.refresh_src]
        return r * self.dirichlet_keep

    # ----------------------------------------------------------- exchange
    #: the exchange kernel's plan (ops/assembly_exchange.py) on a CUDA operator
    exchange_plan = None

    def exchange(self, r: torch.Tensor) -> torch.Tensor:
        """Sum duplicated slots (the assembly exchange) into a new tensor."""
        return self.exchange_(r.clone())

    def exchange_(self, r: torch.Tensor) -> torch.Tensor:
        """The assembly exchange in place on ``r``, which the caller gives
        up; returns the result: irregular group sums (from raw values),
        structured plane sweeps, then the irregular slots overwritten (the
        kernel on a CUDA float32 or float64 vector, else the torch chain)."""
        return assembly_exchange.exchange_(self, r)

    # -------------------------------------------------------------- apply
    def cell_apply_raw(self, x: torch.Tensor) -> torch.Tensor:
        """Per-patch stencil (the CUDA kernel on the card) + per-singleton
        element GEMM; the result is pre-exchange."""
        parts = []
        if self.NP:
            xp = x[: self.patch_slots].view(self.NP, self.S**3)
            parts.append(
                patch_stencil(xp, self.KS, self.MS, self.pscale, self.band).reshape(-1)
            )
        if self.NS:
            rs = torch.matmul(self._singles(x), self.elem) * self.sscale[:, None]
            parts.append(rs.reshape(-1))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def vmult_split(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``vmult`` before its last step: (the result of ``apply_ct``, the
        ``keep`` of the identity blend on constrained slots).  The Chebyshev
        smoother fuses the blend into its step (ops/chebyshev_step.py)."""
        r = spanned(CELL_APPLY, self.cell_apply_raw, spanned(APPLY_C, self.apply_c, x))
        r = spanned(APPLY_CT_FACES, self.apply_ct_faces, r)
        r = spanned(EXCHANGE, self.exchange_, r)
        return spanned(APPLY_CT, self.apply_ct, r), self.constrained_keep

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        r, keep = self.vmult_split(x)
        # identity on constrained DoFs (reference operator.h:152-183)
        return r * keep + x * (1.0 - keep)


def _last_writers(idx: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(unique targets, position of each one's last occurrence in idx)."""
    rev = idx[::-1]
    slots, first = np.unique(rev, return_index=True)
    return (
        torch.as_tensor(slots, dtype=torch.int64, device=device),
        torch.as_tensor(len(idx) - 1 - first, dtype=torch.int64, device=device),
    )


@setup_span("mgtpu.setup.hybrid_operator")
def make_hybrid_operator(fmt, hanging, device, dtype) -> HybridOperator:
    """Host tables (hybrid_format.hybrid_operator_tables) -> device operator;
    on a device-major level (``fmt.n_shards`` > 1) this rank's part of it
    (ops/hybrid_rank.py), under the initialized process group."""
    from .hybrid_format import hybrid_operator_tables

    tables, meta = hybrid_operator_tables(fmt, hanging)
    if fmt.n_shards > 1:
        from .hybrid_rank import RankHybridOperator

        return RankHybridOperator.build(tables, meta, fmt, device, dtype)
    op = HybridOperator.from_arrays(tables, meta, device, dtype)
    op.fmt = fmt
    return op

