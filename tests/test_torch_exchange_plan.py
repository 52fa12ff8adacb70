"""The assembly exchange's kernel plan (ops/assembly_exchange.py) on the CPU.

The CUDA kernel (csrc/assembly_exchange.cu) runs only on a card; here a
NumPy emulation executes the plan's groups as the kernel does (per axis,
each group reads its members, then writes them; the irregular groups in
axis 0, summed in the order of PyTorch's CUDA reduction) and is held to

  * ``HybridOperator.exchange`` (the torch chain) bit for bit on every slot
    a sweep or cross term completes, in float32 and float64, and within
    two roundings per term on the irregular slots, whose sums the CPU
    chain takes in its own order;
  * the integer-exact host mirrors (``_simulate_sweeps``,
    ``_simulate_full``) and the per-DoF sums, on integer-valued input;

on every level of quadrant hierarchies (patch and singleton sweeps, cross
levels, irregular groups) and hypercube hierarchies (patches only).  The
tests also check the plan's structure (one DoF per group, no slot twice in
an axis) and the dispatch rule.
"""

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.ops import assembly_exchange as AX
from dealii_multigrid_tpu_torch.ops import hybrid_format as HF
from dealii_multigrid_tpu_torch.ops.hybrid import HybridOperator

#: (geometry, refinement, degree): quadrant r=5 p=2 and p=1 hold cross
#: levels; p=1 also levels with singletons left to the irregular groups
HIERARCHIES = [
    ("quadrant", 3, 4),
    ("quadrant", 4, 4),
    ("quadrant", 5, 2),
    ("quadrant", 5, 1),
    ("hypercube", 2, 4),
    ("hypercube", 3, 2),
]

_CACHE: dict = {}


def hierarchy(geo, r, p):
    """[(level, host tables, meta, plan)] of a global-coarsening hierarchy
    on the CPU in float64."""
    key = (geo, r, p)
    if key not in _CACHE:
        seq = tapi.geometric_coarsening_sequence(TG.create(geo, 3, r), -1, -1)
        out = []
        for m in seq:
            lv = tapi.build_level_hybrid(m, p, torch.device("cpu"), torch.float64)
            t, meta = HF.hybrid_operator_tables(lv.fmt, lv.hanging)
            out.append((lv, t, meta, AX.ExchangePlan.build(t, meta)))
        _CACHE[key] = out
    return _CACHE[key]


# ------------------------------------------------------------ the emulation
def patch_point(S, axis, pos, u, v):
    if axis == 0:
        return pos * S * S + u * S + v
    if axis == 1:
        return u * S * S + pos * S + v
    return u * S * S + v * S + pos


def single_point(n, axis, pos, u, v):
    if axis == 0:
        return (v * n + u) * n + pos
    if axis == 1:
        return (v * n + pos) * n + u
    return (pos * n + v) * n + u


def torch_cuda_sum(vals: np.ndarray):
    """Sum of n contiguous values as PyTorch's CUDA reduction takes it."""
    n, w = len(vals), 1
    while 2 * w <= n:
        w *= 2
    zero = vals.dtype.type(0)
    part = []
    for t in range(w):
        acc = [zero] * 4
        for j, i in enumerate(range(t, n, w)):
            acc[j & 3] = acc[j & 3] + vals[i]
        part.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    off = w >> 1
    while off:
        for t in range(off):
            part[t] = part[t] + part[t + off]
        off >>= 1
    return part[0]


def blocks_of(S, K, p, s):
    if s == 0:
        return [(0, 0)]
    if s == S - 1:
        return [(K - 1, p)]
    if s % p == 0:
        return [(s // p - 1, p), (s // p, 0)]
    return [(s // p, s % p)]


def axis_groups(plan, a):
    """The groups of axis ``a`` as the kernel forms them: a list of
    (kind, slots), kind "pair" (two slots), "star" (patch slot first, then
    the singleton slots in the einsum's order) or "irr"."""
    S, n1, K, p = plan.S, plan.n1, plan.K, plan.n1 - 1
    irr = irregular_flags(plan)
    ps = plan.NP * S**3
    out = []
    uu, vv = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    for lo, hi in np.asarray(plan.pp[a]).reshape(-1, 2).tolist():
        sa = (lo * S**3 + patch_point(S, a, S - 1, uu, vv)).reshape(-1)
        sb = (hi * S**3 + patch_point(S, a, 0, uu, vv)).reshape(-1)
        out += [("pair", (x, y)) for x, y in zip(sa.tolist(), sb.tolist()) if not irr[x]]
    vs, us = np.meshgrid(np.arange(n1), np.arange(n1), indexing="ij")
    sx = plan.saxes[a]
    for lo, hi in np.asarray(plan.ss[a]).reshape(-1, 2).tolist():
        sa = (ps + lo * plan.nloc + single_point(n1, sx, n1 - 1, us, vs)).reshape(-1)
        sb = (ps + hi * plan.nloc + single_point(n1, sx, 0, us, vs)).reshape(-1)
        out += [("pair", (x, y)) for x, y in zip(sa.tolist(), sb.tolist()) if not irr[x]]
    for row in np.asarray(plan.xf[a]).tolist():
        P, side, blk = row[0], row[1], row[2:]
        spos = 0 if side else n1 - 1
        for s in range(S):
            for t in range(S):
                pslot = P * S**3 + patch_point(S, a, S - 1 if side else 0, s, t)
                if irr[pslot]:
                    continue
                members = [
                    [ps + blk[b1 * K + b2] * plan.nloc + single_point(n1, a, spos, i1, i2)
                     if blk[b1 * K + b2] >= 0 else None
                     for b1, i1 in blocks_of(S, K, p, s)]
                    for b2, i2 in blocks_of(S, K, p, t)
                ]
                if any(m is not None for col in members for m in col):
                    out.append(("star", (pslot, members)))
    if a == 0 and plan.irr_off is not None:
        off = np.asarray(plan.irr_off)
        slots = np.asarray(plan.irr_slots)
        out += [("irr", tuple(slots[off[g]:off[g + 1]].tolist())) for g in range(len(off) - 1)]
    return out


def irregular_flags(plan):
    flags = np.zeros(plan.n_slots, bool)
    if plan.irr_slots is not None:
        flags[np.asarray(plan.irr_slots)] = True
    return flags


def emulate(plan, r: np.ndarray) -> np.ndarray:
    """The kernel's three launches on a copy of ``r`` (NumPy scalars of
    r's dtype, each operation rounded on its own)."""
    r = r.copy()
    zero = r.dtype.type(0)
    for a in range(3):
        writes = []
        for kind, g in axis_groups(plan, a):
            if kind == "pair":
                x, y = r[g[0]], r[g[1]]
                writes += [(g[0], x + y), (g[1], y + x)]
            elif kind == "star":
                pslot, members = g
                vp, z, ms = r[pslot], zero, []
                for col in members:
                    c = zero
                    for m in col:
                        if m is not None:
                            c = c + r[m]
                            ms.append(m)
                    z = z + c
                writes += [(pslot, vp + z)] + [(m, r[m] + vp) for m in ms]
            else:
                s = torch_cuda_sum(r[list(g)])
                writes += [(m, s) for m in g]
        for slot, val in writes:
            r[slot] = val
    return r


def levels_of(case):
    return [(i, lv, t, meta, plan) for i, (lv, t, meta, plan) in enumerate(hierarchy(*case))]


def consistent_raw(lv, dtype, seed):
    """A raw slot vector: a global draw through ``fmt.from_global``, then
    a per-slot draw on top (each cell's own part differs)."""
    rng = np.random.default_rng(seed)
    u = lv.fmt.from_global(rng.normal(size=lv.dofh.n_dofs))
    return (u + rng.normal(size=u.shape) * 0.5).astype(dtype)


def torch_op(lv, dtype):
    t, meta = HF.hybrid_operator_tables(lv.fmt, lv.hanging)
    return HybridOperator.from_arrays(t, meta, torch.device("cpu"), dtype)


# ------------------------------------------------------------------- tests
@pytest.mark.parametrize("case", HIERARCHIES, ids=lambda c: f"{c[0]}_r{c[1]}_p{c[2]}")
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_emulated_plan_matches_the_torch_chain(case, dtype):
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    eps = np.finfo(dtype).eps
    for i, lv, _t, _meta, plan in levels_of(case):
        raw = consistent_raw(lv, dtype, seed=10 + i)
        want = torch_op(lv, tdtype).exchange(torch.as_tensor(raw)).numpy()
        got = emulate(plan, raw)
        irr = irregular_flags(plan)
        assert np.array_equal(got[~irr], want[~irr]), f"level {i}: a swept slot differs"
        if plan.irr_off is not None:
            off, slots = np.asarray(plan.irr_off), np.asarray(plan.irr_slots)
            for g in range(len(off) - 1):
                members = slots[off[g]:off[g + 1]]
                bound = 2 * (len(members) - 1) * eps * np.abs(raw[members]).sum()
                assert np.abs(got[members] - want[members]).max() <= bound, f"level {i} group {g}"


@pytest.mark.parametrize("case", HIERARCHIES, ids=lambda c: f"{c[0]}_r{c[1]}_p{c[2]}")
def test_emulated_plan_is_integer_exact(case):
    """Integer-valued raw slots: the exchange gives every slot its DoF's
    sum, and each swept slot the host mirrors' value."""
    for i, lv, t, meta, plan in levels_of(case):
        fmt = lv.fmt
        rng = np.random.default_rng(20 + i)
        raw = rng.integers(-(1 << 20), 1 << 20, size=fmt.n_slots).astype(np.float64)
        got = emulate(plan, raw)
        dof_sum = np.bincount(fmt.slot_dof, weights=raw, minlength=lv.dofh.n_dofs)
        assert np.array_equal(got, dof_sum[fmt.slot_dof]), f"level {i}"
        S, NP, NS, n1 = fmt.S, fmt.n_patches, fmt.n_singles, plan.n1
        irr = irregular_flags(plan)
        iraw = raw.astype(np.int64)
        if meta["use_cross"]:
            up, us = HF._simulate_full(
                iraw[: NP * S**3].reshape(NP, S, S, S), iraw[NP * S**3:].reshape(NS, n1, n1, n1),
                fmt.nbr, fmt.nbr_s, fmt.cross_faces, S, n1, fmt.K, True)
            sim = np.concatenate([up.reshape(-1), us.reshape(-1)])
        else:
            sim = iraw.copy()
            if NP:
                sim[: NP * S**3] = HF._simulate_sweeps(
                    iraw[: NP * S**3].reshape(NP, S, S, S), fmt.nbr, S).reshape(-1)
            if NS and meta["use_ssweep"]:
                sim[NP * S**3:] = HF._simulate_sweeps(
                    iraw[NP * S**3:].reshape(NS, n1, n1, n1), fmt.nbr_s[HF.SINGLE_SWEEP_ROWS],
                    n1).reshape(-1)
        assert np.array_equal(got[~irr].astype(np.int64), sim[~irr]), f"level {i}"


@pytest.mark.parametrize("case", HIERARCHIES, ids=lambda c: f"{c[0]}_r{c[1]}_p{c[2]}")
def test_plan_groups_hold_one_dof_and_no_slot_twice(case):
    """No race: within an axis every slot is in at most one group; every
    group holds the slots of one DoF, all irregular or none."""
    for i, lv, _t, _meta, plan in levels_of(case):
        slot_dof = lv.fmt.slot_dof
        irr = irregular_flags(plan)
        for a in range(3):
            seen = []
            for kind, g in axis_groups(plan, a):
                slots = ([g[0]] + [m for col in g[1] for m in col if m is not None]
                         if kind == "star" else list(g))
                assert len(set(slot_dof[slots].tolist())) == 1, f"level {i} axis {a}: {kind}"
                assert len(set(irr[slots].tolist())) == 1, f"level {i} axis {a}: {kind}"
                seen += slots
            assert len(seen) == len(set(seen)), f"level {i} axis {a}: a slot in two groups"
        if plan.irr_slots is not None:
            out = np.concatenate([np.asarray(b[1]) for b in _t["irr_buckets"]])
            assert set(out.tolist()) == set(np.asarray(plan.irr_slots).tolist())


@pytest.mark.parametrize("case", HIERARCHIES, ids=lambda c: f"{c[0]}_r{c[1]}_p{c[2]}")
def test_plan_shape_follows_the_level(case):
    """At most three launches; patch pairs wherever patches meet, cross
    faces only on cross levels, singleton pairs only where singletons are
    swept, irregular groups none on the hypercube."""
    for i, lv, _t, meta, plan in levels_of(case):
        assert plan.launches <= 3
        assert bool(sum(len(x) for x in plan.xf)) == bool(meta["use_cross"])
        if not (meta["use_cross"] or meta["use_ssweep"]):
            assert not sum(len(x) for x in plan.ss)
        if case[0] == "hypercube":
            assert plan.irr_off is None and not sum(len(x) for x in plan.xf)
        if meta["NP"] >= 2 and (lv.fmt.nbr >= 0).any():
            assert plan.launches == 3
        assert plan.bytes(torch.float64) == 2 * plan.bytes(torch.float32)


def test_the_hierarchies_hold_every_level_shape():
    shapes = {(bool(m["NP"]), bool(m["NS"]), bool(m["use_ssweep"]), bool(m["use_cross"]),
               p.irr_off is not None)
              for case in HIERARCHIES for _lv, _t, m, p in hierarchy(*case)}
    assert (True, True, True, True, True) in shapes      # cross, singleton sweeps, groups
    assert (True, False, False, False, False) in shapes  # patches only
    assert (True, True, False, False, True) in shapes    # singletons left to the groups
    assert (False, True, True, False, False) in shapes   # singletons only, swept


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_cpu_and_bfloat16_take_the_torch_chain(dtype, monkeypatch):
    lv, *_ = hierarchy("quadrant", 4, 4)[-1]
    op = torch_op(lv, dtype)
    assert op.exchange_plan is None
    r = torch.as_tensor(consistent_raw(lv, np.float64, 3)).to(dtype)
    assert not AX.takes_kernel(r)
    calls = []
    chain = AX.reference_
    monkeypatch.setattr(AX, "reference_", lambda o, v: calls.append(1) or chain(o, v))
    op.exchange_(r.clone())
    assert calls == [1]


def test_the_rule_reads_device_and_dtype():
    for dtype in (torch.float32, torch.float64, torch.bfloat16, torch.float16):
        assert not AX.takes_kernel(torch.zeros(2, dtype=dtype))
    assert set(AX.DTYPES) == {torch.float32, torch.float64}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exchange_in_place_leaves_no_alias(dtype):
    """``exchange_`` returns its input, changed; ``exchange`` a new tensor
    and leaves its input as it was."""
    lv, *_ = hierarchy("quadrant", 5, 2)[4]
    op = torch_op(lv, dtype)
    assert op.use_cross
    raw = torch.as_tensor(consistent_raw(lv, np.float64, 4)).to(dtype)
    keep = raw.clone()
    out = op.exchange(raw)
    assert torch.equal(raw, keep)
    assert out.untyped_storage().data_ptr() != raw.untyped_storage().data_ptr()
    buf = raw.clone()
    got = op.exchange_(buf)
    assert got.data_ptr() == buf.data_ptr() and got.shape == buf.shape
    assert torch.equal(got, out)
    assert not torch.equal(got, keep)
