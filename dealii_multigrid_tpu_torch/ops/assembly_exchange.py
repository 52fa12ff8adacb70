"""The hybrid operator's assembly exchange: one kernel launch per sweep axis.

``exchange_(op, r)`` sums, in place, the slots of ``r`` that hold one DoF
(the operator's bulk compute leaves each cell's part in its own slot) and
returns ``r``.  On a CUDA tensor of float32 or float64 it launches the
hand-written kernel in ``csrc/assembly_exchange.cu`` (built and counted as
ops/kernels.py sets out) once per sweep axis with a nonempty plan, at most
three times; everything else (CPU tensors, bfloat16 levels, whose
fixed-order sums add one source at a time) runs the plain version,
``reference_``: PyTorch's chain of the JAX package's plain path
(dealii_multigrid_tpu/ops/hybrid.py, ``HybridOperator.exchange``)

  1. the irregular groups' sums from the raw values;
  2. per axis, the face-plane sweeps of the patch and singleton buckets
     and, on levels with ``use_cross``, the patch<->singleton cross terms,
     each axis's adds read from the values before the axis;
  3. the irregular slots overwritten with their sums.

``ExchangePlan`` is the kernel's plan, derived on the host from the tables
the operator already holds (``nbr``, ``snbr``, ``cross``, ``irr_buckets``):
per axis the patch face pairs, singleton face pairs and patch faces with
cross terms, and the irregular groups, all int32.  The kernel gives the
plain version's result on the card (the order of each sum is the chain's;
see the source).  It allocates nothing, so a CUDA graph captures it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

#: the kernel's entry point per dtype
_ENTRY = {torch.float32: "assembly_exchange_f32", torch.float64: "assembly_exchange_f64"}
#: the dtypes the kernel takes
DTYPES = tuple(_ENTRY)
#: the largest irregular group the kernel sums in PyTorch's order
MAX_GROUP = 63

#: launches of the CUDA kernel that reached the card (ops/kernels.py)
launches = kernels.counter("assembly_exchange")


def bind(lib: ctypes.CDLL, path: str) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = [vp, vp, ll, vp, ll, vp, ll, vp, vp, ll, vp, i, i, i, i, ll, i, i, i, vp]


library = kernels.Library("assembly_exchange", bind)


def takes_kernel(r: torch.Tensor) -> bool:
    """The rule: the kernel runs on CUDA tensors of float32 or float64."""
    return r.is_cuda and r.dtype in DTYPES


def exchange_(op, r: torch.Tensor) -> torch.Tensor:
    """In place: the exchange of ``op`` (a HybridOperator) on ``r``."""
    if takes_kernel(r):
        return op.exchange_plan.launch(r)
    return reference_(op, r)


# ------------------------------------------------------------- plain version
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


def _exchange_cross(op, r: torch.Tensor) -> None:
    """In place on ``r``: per geometric axis, patch sweeps, singleton
    sweeps AND patch<->singleton cross terms, all adds within an axis
    computed from pre-axis values (host mirror: _simulate_full)."""
    S, n1, K = op.S, op.n1, op.K
    NP, NS = op.NP, op.NS
    E = op.Easm
    up = op._patches(r)
    us = op._singles(r).view(NS, n1, n1, n1)
    for g in range(3):
        sax = 3 - g
        p_lo, p_hi = up.select(g + 1, 0), up.select(g + 1, S - 1)
        s_lo, s_hi = us.select(sax, 0), us.select(sax, n1 - 1)
        add_plo = p_hi[op.nbr[2 * g]] * op.nbr_mask[2 * g].view(-1, 1, 1)
        add_phi = p_lo[op.nbr[2 * g + 1]] * op.nbr_mask[2 * g + 1].view(-1, 1, 1)
        ds = 2 - g  # snbr tables are lattice-axis ([z, y, x]) ordered
        add_slo = s_hi[op.snbr[2 * ds]] * op.snbr_mask[2 * ds].view(-1, 1, 1)
        add_shi = s_lo[op.snbr[2 * ds + 1]] * op.snbr_mask[2 * ds + 1].view(-1, 1, 1)
        for side_p in (0, 1):
            tbl = op.cross[2 * g + side_p]
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
            csum = op.cross_sums[2 * g + side_p]
            if side_p == 0:
                add_plo = add_plo + Z
                add_shi = csum.add_into(add_shi, subT)
            else:
                add_phi = add_phi + Z
                add_slo = csum.add_into(add_slo, subT)
        p_lo.add_(add_plo)
        p_hi.add_(add_phi)
        s_lo.add_(add_slo)
        s_hi.add_(add_shi)


def reference_(op, r: torch.Tensor) -> torch.Tensor:
    """The plain version, in place: irregular group sums (from raw values),
    then structured plane sweeps, then the irregular slots overwritten."""
    sums = [r[slots].sum(-1) for slots, _, _ in op.irr_buckets]
    if op.use_cross:
        _exchange_cross(op, r)
    else:
        if op.NP:
            _sweeps(op._patches(r), op.nbr, op.nbr_mask, op.S)
        if op.NS and op.use_ssweep:
            n1 = op.n1
            us = op._singles(r).view(op.NS, n1, n1, n1)
            _sweeps(us, op.snbr, op.snbr_mask, n1)
    if sums:
        # ONE combined scatter for all size buckets (their dofs are disjoint)
        out_all = torch.cat([b[1] for b in op.irr_buckets])
        val_all = torch.cat([s[b[2]] for b, s in zip(op.irr_buckets, sums)])
        r[out_all] = val_all
    return r


# ------------------------------------------------------------------ the plan
def _pairs(nbr: np.ndarray, mask: np.ndarray, d: int) -> np.ndarray:
    """[n, 2] int32 (lower, upper) of the face pairs along table axis ``d``
    (rows 2d: lower neighbour, 2d + 1: upper neighbour, clamped at 0)."""
    has_lower = np.asarray(mask[2 * d]) > 0
    lower = np.nonzero(np.asarray(mask[2 * d + 1]) > 0)[0]
    upper = np.asarray(nbr[2 * d + 1])[lower]
    if has_lower.sum() != len(lower) or not (np.asarray(nbr[2 * d])[upper] == lower).all():
        raise ValueError("face neighbour tables are not symmetric")
    return np.stack([lower, upper], axis=1).astype(np.int32).reshape(-1, 2)


class ExchangePlan:
    """Per sweep axis the groups the kernel sums (int32 host arrays until
    ``to``): ``pp[a]`` patch face pairs, ``ss[a]`` singleton face pairs,
    ``xf[a]`` patch faces with cross terms (patch, side, then the singleton
    at each of the face's K x K sub-blocks or -1); the irregular groups
    (``irr_off``, ``irr_slots``, in axis 0's launch) and a bit per slot
    marking them (``irr_bits``)."""

    def __init__(self, meta: dict, K: int, n1: int, pp, ss, xf, saxes, irr_off, irr_slots,
                 irr_bits):
        self.S, self.NP, self.NS = meta["S"], meta["NP"], meta["NS"]
        self.nloc, self.n_slots = meta["nloc"], meta["n_slots"]
        self.K, self.n1 = K, n1
        self.pp, self.ss, self.xf, self.saxes = pp, ss, xf, saxes
        self.irr_off, self.irr_slots, self.irr_bits = irr_off, irr_slots, irr_bits
        #: group members over the three axes: each read and written once
        self.members = sum(
            2 * (len(pp[a]) * self.S**2 + len(ss[a]) * n1**2) + self._star_members(xf[a])
            for a in range(3)
        ) + (0 if irr_slots is None else len(irr_slots))
        self.device: torch.device | None = None
        self._args: list = []

    @classmethod
    def build(cls, t: dict, meta: dict) -> "ExchangePlan":
        """The plan of the operator tables ``t`` and ``meta``
        (hybrid_format.hybrid_operator_tables) on the host."""
        S, NP, NS, nloc = meta["S"], meta["NP"], meta["NS"], meta["nloc"]
        n1 = round(nloc ** (1 / 3))
        K = (S - 1) // max(n1 - 1, 1)
        if meta["n_slots"] >= 2**31:
            raise ValueError(f"{meta['n_slots']} slots: the plan indexes them in int32")
        cross = t["cross"] or (None,) * 6
        use_cross, use_ss = meta["use_cross"], NS and (meta["use_cross"] or meta["use_ssweep"])
        none = np.zeros((0, 2), np.int32)
        pp, ss, xf, saxes = [], [], [], []
        for a in range(3):
            pp.append(_pairs(t["nbr"], t["nbr_mask"], a) if NP else none)
            # the singleton sweep's lattice axis ([z, y, x]): the cross path
            # sweeps x, y, z beside the patch axes, the plain one z, y, x
            li = 2 - a if use_cross else a
            saxes.append(2 - li)
            ss.append(_pairs(t["snbr"], t["snbr_mask"], li) if use_ss else none)
            faces = {}
            for side in (0, 1):
                tbl = cross[2 * a + side] if use_cross else None
                if tbl is None:
                    continue
                ppos, sidx = (np.asarray(v, np.int64) for v in tbl)
                if len(np.unique(sidx)) != len(sidx):
                    raise ValueError("a singleton meets two patch sub-blocks on one face")
                for pos, s in zip(ppos.tolist(), sidx.tolist()):
                    row = faces.setdefault((pos // (K * K), side), np.full(K * K, -1, np.int32))
                    if row[pos % (K * K)] >= 0:
                        raise ValueError("two singletons on one patch sub-block")
                    row[pos % (K * K)] = s
            xf.append(
                np.array([[p, side, *row] for (p, side), row in sorted(faces.items())], np.int32)
                .reshape(-1, 2 + K * K)
            )
        groups = [np.asarray(slots) for slots, _, _ in t["irr_buckets"]]
        groups = [g for g in groups if g.size]
        if groups:
            sizes = np.concatenate([np.full(len(g), g.shape[1]) for g in groups])
            if sizes.max() > MAX_GROUP:
                raise ValueError(f"an irregular group of {sizes.max()} slots (at most {MAX_GROUP})")
            irr_slots = np.concatenate([g.reshape(-1) for g in groups]).astype(np.int32)
            irr_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
            flags = np.zeros(32 * ((meta["n_slots"] + 31) // 32), bool)
            flags[irr_slots] = True
            irr_bits = np.packbits(flags, bitorder="little").view("<i4")
        else:
            irr_off = irr_slots = irr_bits = None
        return cls(meta, K, n1, pp, ss, xf, saxes, irr_off, irr_slots, irr_bits)

    @property
    def n_groups(self) -> int:
        return 0 if self.irr_off is None else len(self.irr_off) - 1

    def threads(self, a: int) -> int:
        """Threads of axis ``a``'s launch: one per group point."""
        return ((len(self.pp[a]) + len(self.xf[a])) * self.S**2 + len(self.ss[a]) * self.n1**2
                + (self.n_groups if a == 0 else 0))

    @property
    def launches(self) -> int:
        """Kernel launches per exchange: the axes with a group."""
        return sum(1 for a in range(3) if self.threads(a))

    def bytes(self, dtype: torch.dtype) -> int:
        """Least bytes an exchange moves: each group member read and
        written once per axis (index tables left out)."""
        return 2 * torch.empty((), dtype=dtype).element_size() * self.members

    def _star_members(self, xf: np.ndarray) -> int:
        """Slots of one axis's cross stars: each singleton point and the
        patch points they land on."""
        if not len(xf):
            return 0
        S, K, p = self.S, self.K, self.n1 - 1
        covered = np.zeros((len(xf), S, S), bool)
        for b in range(K * K):
            has = np.nonzero(xf[:, 2 + b] >= 0)[0]
            b1, b2 = divmod(b, K)
            covered[has, b1 * p : b1 * p + p + 1, b2 * p : b2 * p + p + 1] = True
        return int(covered.sum()) + int((xf[:, 2:] >= 0).sum()) * self.n1**2

    def to(self, device) -> "ExchangePlan":
        """The plan's tables on ``device`` (in place; returns the plan)."""
        self.device = torch.device(device)

        def dev(a):
            return None if a is None else torch.as_tensor(a, device=self.device).contiguous()

        self.pp = [dev(v) for v in self.pp]
        self.ss = [dev(v) for v in self.ss]
        self.xf = [dev(v) for v in self.xf]
        self.irr_off, self.irr_slots, self.irr_bits = (
            dev(self.irr_off), dev(self.irr_slots), dev(self.irr_bits))

        def ptr(a):
            return None if a is None or not a.numel() else a.data_ptr()

        self._args = [
            (ptr(self.pp[a]), len(self.pp[a]), ptr(self.ss[a]), len(self.ss[a]),
                 ptr(self.xf[a]), len(self.xf[a]),
                 ptr(self.irr_off) if a == 0 else None,
                 ptr(self.irr_slots) if a == 0 else None,
                 self.n_groups if a == 0 else 0, ptr(self.irr_bits),
             self.S, self.n1, self.K, self.nloc, self.NP * self.S**3, a, self.saxes[a])
            for a in range(3) if self.threads(a)
        ]
        return self

    def launch(self, r: torch.Tensor) -> torch.Tensor:
        """In place: the exchange on the CUDA slot vector ``r``; returns it."""
        if self.device is None or r.device != self.device:
            raise ValueError(f"the exchange plan is on {self.device}, the vector on {r.device}")
        if r.dtype not in _ENTRY:
            raise ValueError(f"the exchange kernel takes float32 or float64, got {r.dtype}")
        if r.dim() != 1 or r.shape[0] != self.n_slots or not r.is_contiguous():
            raise ValueError(f"r must be a contiguous vector of {self.n_slots} slots, "
                             f"got {tuple(r.shape)}")
        device = r.device.index or 0
        fn = getattr(library.for_device(device), _ENTRY[r.dtype])
        stream = torch.cuda.current_stream(r.device).cuda_stream
        for args in self._args:
            library.check(fn(r.data_ptr(), *args, device, stream), "launch")
            launches.add(r.dtype)
        return r

