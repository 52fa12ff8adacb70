"""bfloat16 levels: the port's solves take the JAX package's iteration counts (CPU).

Quadrant r=3 p=4 (9,295 DoFs), coarse type amg, Chebyshev degree 3, rtol
1e-4: HMG-global with bfloat16 levels under float and under double, float
under float, HPMG and HMG-local with bfloat16 levels under double take 4,
4, 4, 4 and 5 iterations in the JAX package, and the port must take the
same.  Each level's Chebyshev interval is printed beside the JAX package's:
both estimate it with 20 CG-Lanczos steps in bfloat16 from the same start
vector, and roundoff moves the estimate.  With the JAX intervals copied in,
one bfloat16 V-cycle of HMG-global agrees with the JAX package's to 3e-2 of
its maximum.

The card's bfloat16 kernel rounds its stencil once, where the plain chain
(and the JAX package's XLA chain) rounds after each contraction; that moves
HMG-local's count from 5 to 4.  Two CPU runs with a stencil rounded once
witness the card's count: the port's, and the JAX package's with
``HybridOperator.cell_apply_raw`` so rounded.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.ops.hybrid import HybridOperator, pack_buckets
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams
from test_torch_2d_solve import copy_intervals

#: (Type, MGNumberType, NumberType, the JAX package's count)
ROWS = [
    ("HMG-global", "bfloat16", "float", 4),
    ("HMG-global", "bfloat16", "double", 4),
    ("HMG-global", "float", "float", 4),
    ("HPMG", "bfloat16", "double", 4),
    ("HMG-local", "bfloat16", "double", 5),
]


def port_stencil_rounded_once(xp, KS, MS, pscale, plain=ps.patch_stencil_reference):
    """The port's CPU stencil, rounded as the card's kernel rounds: in
    bfloat16, a float64 stencil of the bfloat16 inputs rounded once."""
    if xp.dtype != torch.bfloat16:
        return plain(xp, KS, MS, pscale)
    return plain(*(t.double() for t in (xp, KS, MS, pscale))).to(torch.bfloat16)


def jax_cell_apply_rounded_once(self, x, plain=HybridOperator.cell_apply_raw):
    """``HybridOperator.cell_apply_raw`` of the JAX package with its patch
    stencil rounded as the card's kernel rounds (the singleton GEMM as it
    is); an independent witness beside ``port_stencil_rounded_once``."""
    if x.dtype != jnp.bfloat16 or not self.NP:
        return plain(self, x)
    assert not self.use_tstencil, "the CPU runs the patch-major stencil"
    f64 = jnp.float64

    def ax(u, mat, axis):
        return jnp.moveaxis(jnp.tensordot(u, mat.astype(f64), axes=([axis], [1])), -1, axis)

    up = self._patches(x).astype(f64)
    KS, MS = self.KS, self.MS
    kx = ax(ax(ax(up, KS, 1), MS, 2), MS, 3)
    ky = ax(ax(ax(up, MS, 1), KS, 2), MS, 3)
    kz = ax(ax(ax(up, MS, 1), MS, 2), KS, 3)
    rp = ((kx + ky + kz) * self.pscale.astype(f64)[:, None, None, None]).astype(x.dtype)
    rs = None
    if self.NS:
        xs = self._singles(x)
        rs = jnp.matmul(xs, self.elem, precision=jax.lax.Precision.HIGHEST) * self.sscale[:, None]
    return pack_buckets(rp, rs, self.n_shards)


def jax_run_rounded_once(prm):
    """``japi.run`` with the stencil rounded once; the compilation caches
    are cleared on both sides so that no trace of the plain chain is reused
    and none of this one outlives the run."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(HybridOperator, "cell_apply_raw", jax_cell_apply_rounded_once)
        try:
            return japi.run(prm)
        finally:
            jax.clear_caches()


def params(cls, mg_type, mg_number, number, r=3, p=4):
    prm = cls()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.number_type = number
    prm.mg_number_type = mg_number
    prm.mg_data.coarse_solver.type = "amg"
    prm.mg_data.smoother.degree = 3
    prm.mg_data.cg_normal.reltol = 1e-4
    prm.mg_data.n_repetitions = 1
    return prm


@functools.lru_cache(maxsize=None)
def solved(mg_type, mg_number, number):
    """Both packages' solves of one row (the V-cycle test reuses a row's)."""
    jres, _, _ = japi.run(params(JParams, mg_type, mg_number, number))
    tres, _, levels = tapi.run(params(TParams, mg_type, mg_number, number), "cpu")
    return jres, tres, levels


def smoothers(res, jax_side: bool):
    if jax_side:
        m = res.mg
        return getattr(m, "lsmg", m).smoothers
    return (res.ls_mg if res.mg is None else res.mg).smoothers


@pytest.mark.parametrize("mg_type,mg_number,number,n_jax", ROWS)
def test_bf16_solve_counts_match_jax(mg_type, mg_number, number, n_jax):
    jres, tres, levels = solved(mg_type, mg_number, number)
    for l, (s, j) in enumerate(zip(smoothers(tres, False), smoothers(jres, True))):
        if s is not None:
            print(f"{mg_type} {number}/{mg_number} level {l}: Chebyshev interval centre, "
                  f"half-width port {s.theta:.6g} {s.delta:.6g}, JAX {float(j.theta):.6g} "
                  f"{float(j.delta):.6g}")
    print(f"{mg_type} {number}/{mg_number}: port {tres.solve_iterations}, JAX {jres.n_iterations}")
    assert jres.converged and jres.n_iterations == n_jax
    assert tres.converged and tres.solve_iterations == [n_jax] * 2
    assert tres.true_residual <= tres.guard_threshold
    level_dtype = torch.bfloat16 if mg_number == "bfloat16" else torch.float32
    assert levels[-1].op.dtype == level_dtype
    assert tres.x.dtype == tapi.number_dtype(number)
    jx = np.array(jres.x, np.float64)
    rel = float(np.linalg.norm(tres.x.double().numpy() - jx) / np.linalg.norm(jx))
    print(f"{mg_type} {number}/{mg_number}: x port vs JAX {rel:.3e} (2-norm, relative)")
    assert rel <= 1e-2


def test_bf16_v_cycle_with_jax_intervals():
    """HMG-global r=3 p=4 with bfloat16 levels: one V-cycle with the JAX
    smoothers' intervals agrees with the JAX package's to 3e-2 of max."""
    jres, tres, levels = solved("HMG-global", "bfloat16", "float")
    jmg = jres.mg
    tmg = dataclasses.replace(tres.mg, smoothers=copy_intervals(tres.mg.smoothers, jmg.smoothers))
    fine = levels[-1]
    b = np.random.default_rng(7).standard_normal(fine.dofh.n_dofs)
    x = fine.fmt.from_global(b) * fine.op.constrained_keep.double().numpy()
    want = np.asarray(jax.jit(lambda m, v: m.vmult(v))(jmg, jnp.asarray(x, jnp.bfloat16)),
                      np.float64)
    got = tmg.vmult(torch.as_tensor(x, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())
    print(f"bf16 V-cycle with the JAX intervals: port vs JAX {err:.3e} of max|ref|")
    assert err <= 3e-2


def test_bf16_v_cycle_bit_equal_to_jax_stage_by_stage():
    """HMG-global r=3 p=4 with bfloat16 levels and the JAX smoothers'
    intervals: every stage of one V-cycle (each jitted alone on the JAX
    side) and the whole V-cycle (one jit) equal the JAX package's bit for
    bit.  The structured C^T on faces and the restriction's slot-table
    sums are where the packages differed: the port summed a target's
    sources first (torch rounds a bfloat16 sum once) and added the sum,
    the JAX package's scatter-add adds them one at a time; 17 slots of
    apply_ct_faces differed here (ops/fixed_order.py now adds bfloat16
    sources one at a time)."""
    jres, tres, levels = solved("HMG-global", "bfloat16", "float")
    jmg = jres.mg
    tmg = dataclasses.replace(tres.mg, smoothers=copy_intervals(tres.mg.smoothers, jmg.smoothers))
    fine = levels[-1]
    b = np.random.default_rng(7).standard_normal(fine.dofh.n_dofs)
    x = fine.fmt.from_global(b) * fine.op.constrained_keep.double().numpy()
    diffs = v_cycle_stages(jmg, tmg, x)
    print("bf16 V-cycle stages, slots that differ:", diffs)
    assert all(n == 0 for n in diffs.values()), diffs


def v_cycle_stages(jmg, tmg, x) -> dict:
    """Slots that differ between the two packages' bfloat16 V-cycle stages:
    on the finest level apply_c, apply_ct_faces, exchange, apply_ct and
    the whole vmult; on every level above the coarsest the pre-smoothing,
    the residual and the restriction; the coarse solve; on the way up the
    prolongation and the post-smoothing; the whole V-cycle in one jit.
    Each stage takes the JAX side's previous output on both sides."""
    J = jax.jit

    def as_t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=torch.bfloat16)

    def nd(jv, tv):
        return int((np.asarray(jv, np.float64) != tv.double().numpy()).sum())

    out = {}
    jb = jnp.asarray(x, jnp.bfloat16)
    L = len(tmg.operators) - 1
    jop, top = jmg.operators[L], tmg.operators[L]
    out["apply_c"] = nd(J(lambda o, v: o.apply_c(v))(jop, jb), top.apply_c(as_t(jb)))
    raw = J(lambda o, v: o.cell_apply_raw(o.apply_c(v)))(jop, jb)
    f = J(lambda o, v: o.apply_ct_faces(v))(jop, raw)
    out["apply_ct_faces"] = nd(f, top.apply_ct_faces(as_t(raw)))
    e = J(lambda o, v: o.exchange(v))(jop, f)
    out["exchange"] = nd(e, top.exchange(as_t(f)))
    out["apply_ct"] = nd(J(lambda o, v: o.apply_ct(v))(jop, e), top.apply_ct(as_t(e)))
    out["vmult"] = nd(J(lambda o, v: o.vmult(v))(jop, jb), top.vmult(as_t(jb)))
    jbl, down = jb, {}
    for level in range(L, 0, -1):
        jsm, jop, jtr = jmg.smoothers[level], jmg.operators[level], jmg.transfers[level]
        tsm, top, ttr = tmg.smoothers[level], tmg.operators[level], tmg.transfers[level]
        jx = J(lambda sm, v: sm.vmult(v))(jsm, jbl)
        out[f"L{level} pre"] = nd(jx, tsm.vmult(as_t(jbl)))
        jr = J(lambda o, bb, xx: bb - o.vmult(xx))(jop, jbl, jx)
        out[f"L{level} residual"] = nd(jr, as_t(jbl) - top.vmult(as_t(jx)))
        jbc = J(lambda t, v: t.restrict(v))(jtr, jr)
        out[f"L{level} restrict"] = nd(jbc, ttr.restrict(as_t(jr)))
        down[level] = (jbl, jx)
        jbl = jbc
    jxc = J(lambda c, v: c(v))(jmg.coarse_solve, jbl)
    out["coarse solve"] = nd(jxc, tmg.coarse_solve(as_t(jbl)))
    for level in range(1, L + 1):
        jsm, jtr = jmg.smoothers[level], jmg.transfers[level]
        tsm, ttr = tmg.smoothers[level], tmg.transfers[level]
        jbl, jx = down[level]
        jxp = J(lambda t, xx, c: xx + t.prolong(c))(jtr, jx, jxc)
        out[f"L{level} prolong"] = nd(jxp, as_t(jx) + ttr.prolong(as_t(jxc)))
        jxc = J(lambda sm, xx, bb: sm.step(xx, bb))(jsm, jxp, jbl)
        out[f"L{level} post"] = nd(jxc, tsm.step(as_t(jxp), as_t(jbl)))
    out["V-cycle"] = nd(J(lambda m, v: m.vmult(v))(jmg, jb), tmg.vmult(as_t(jb)))
    return out


def test_bf16_2d_solve_count_matches_jax():
    """2D runs on the gather engine in both packages; with bfloat16 levels
    HMG-global at quadrant r=5 p=2 takes the JAX package's count (5)."""
    jp, tp = (params(cls, "HMG-global", "bfloat16", "float", r=5, p=2) for cls in (JParams, TParams))
    jp.dim = tp.dim = 2
    jres, _, _ = japi.run(jp)
    tres, _, levels = tapi.run(tp, "cpu")
    print(f"2D HMG-global r=5 p=2 float/bfloat16: port {tres.solve_iterations}, JAX {jres.n_iterations}")
    assert levels[-1].op.dtype == torch.bfloat16
    assert jres.converged and tres.converged and tres.solve_iterations == [jres.n_iterations] * 2 == [5] * 2


def test_one_rounding_stencil_moves_the_hmg_local_count(monkeypatch):
    """HMG-local r=3 p=4 with bfloat16 levels under double sits at the edge
    of its tolerance: the plain chain takes 5 iterations (JAX: 5), the
    port's stencil rounded once, as the card's kernel, 4; HMG-global keeps
    its count."""
    monkeypatch.setattr(ps, "patch_stencil_reference", port_stencil_rounded_once)
    for mg_type, number, n_once in (("HMG-local", "double", 4), ("HMG-global", "float", 4)):
        res, _, _ = tapi.run(params(TParams, mg_type, "bfloat16", number), "cpu")
        print(f"{mg_type} {number}/bfloat16 with the stencil rounded once: {res.solve_iterations}")
        assert res.converged and res.solve_iterations == [n_once] * 2


#: (Type, NumberType, the JAX package's count with its stencil rounded once)
#: at r=3 p=4 with bfloat16 levels; chip_smoke.py phase x holds the card to
#: these counts
JAX_ROUNDED_ONCE = [
    ("HMG-global", "float", 4),
    ("HMG-global", "double", 4),
    ("HPMG", "double", 4),
    ("HMG-local", "double", 4),
]


@pytest.mark.parametrize("mg_type,number,n_once", JAX_ROUNDED_ONCE)
def test_jax_package_with_the_stencil_rounded_once_takes_the_card_count(mg_type, number, n_once):
    """The JAX package, its patch stencil rounded once as the card's kernel
    rounds, takes the card's counts; at HMG-local its XLA chain takes 5:
    the card's count there is the rounding's, witnessed by code that
    shares nothing with the port."""
    jres, _, _ = jax_run_rounded_once(params(JParams, mg_type, "bfloat16", number))
    print(f"JAX package, {mg_type} {number}/bfloat16, the stencil rounded once: {jres.n_iterations}")
    assert jres.converged and jres.n_iterations == n_once


def test_phase_x_holds_the_card_to_these_counts():
    """chip_smoke.py phase x holds the CPU's plain chain to ROWS and the
    card to JAX_ROUNDED_ONCE."""
    import chip_smoke

    assert [(t, m, n, j) for t, m, n, j, _ in chip_smoke.BF16_SMALL] == [tuple(r) for r in ROWS]
    card = {(t, n): c for t, m, n, _, c in chip_smoke.BF16_SMALL if m == "bfloat16"}
    assert card == {(t, n): c for t, n, c in JAX_ROUNDED_ONCE}


def bf16_counts(refs=(4, 5, 6), jax_max_ref=5) -> None:
    """Counts of HMG-global float/bfloat16 and HPMG mixed/bfloat16 at
    quadrant r in ``refs``, p=4: the port with its plain chain and with the
    stencil rounded once (the card kernel's rounding) and, at r <=
    ``jax_max_ref``, the JAX package with its XLA chain and with the
    stencil rounded once.  Run as ``PYTHONPATH=.:tests python
    tests/test_torch_bf16_solve.py`` (about ten minutes); ``... counts 6``
    runs r=6 alone, the JAX package included."""
    for r in refs:
        for mg_type, number in (("HMG-global", "float"), ("HPMG", "mixed")):
            res, _, _ = tapi.run(params(TParams, mg_type, "bfloat16", number, r=r), "cpu")
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(ps, "patch_stencil_reference", port_stencil_rounded_once)
                once, _, _ = tapi.run(params(TParams, mg_type, "bfloat16", number, r=r), "cpu")
            line = (f"r={r} {mg_type} {number}/bfloat16: port plain chain {res.solve_iterations}, "
                    f"rounded once {once.solve_iterations}")
            if r <= jax_max_ref:
                jres, _, _ = japi.run(params(JParams, mg_type, "bfloat16", number, r=r))
                jonce, _, _ = jax_run_rounded_once(params(JParams, mg_type, "bfloat16", number, r=r))
                line += f"; JAX package XLA chain {jres.n_iterations}, rounded once {jonce.n_iterations}"
            print(line, flush=True)


def bf16_stages(r: int, once: bool = False) -> None:
    """HMG-global quadrant r, p=4, bfloat16 levels under float: both
    packages' counts and the slots that differ at each V-cycle stage
    (``v_cycle_stages``); with ``once`` both packages' stencils round once,
    as the card's kernel rounds.  Run as ``PYTHONPATH=.:tests python
    tests/test_torch_bf16_solve.py stages 4`` (``stages-once 5`` for the
    stencils rounded once); with
    ``XLA_FLAGS=--xla_allow_excess_precision=false`` the JAX package keeps
    every bfloat16 rounding inside its fused programs."""
    with pytest.MonkeyPatch.context() as mp:
        if once:
            jax.clear_caches()
            mp.setattr(HybridOperator, "cell_apply_raw", jax_cell_apply_rounded_once)
            mp.setattr(ps, "patch_stencil_reference", port_stencil_rounded_once)
        _bf16_stages(r, "rounded once" if once else "plain chains")


def _bf16_stages(r: int, what: str) -> None:
    jres, _, _ = japi.run(params(JParams, "HMG-global", "bfloat16", "float", r=r))
    tres, _, levels = tapi.run(params(TParams, "HMG-global", "bfloat16", "float", r=r), "cpu")
    print(f"r={r} ({what}): JAX package {jres.n_iterations} iterations, port "
          f"{tres.solve_iterations}")
    tmg = dataclasses.replace(tres.mg, smoothers=copy_intervals(tres.mg.smoothers, jres.mg.smoothers))
    fine = levels[-1]
    b = np.random.default_rng(7).standard_normal(fine.dofh.n_dofs)
    x = fine.fmt.from_global(b) * fine.op.constrained_keep.double().numpy()
    for stage, n in {**stencil_stages(jres.mg, tmg, x), **v_cycle_stages(jres.mg, tmg, x)}.items():
        print(f"r={r} {stage}: {n} slots differ", flush=True)


def stencil_stages(jmg, tmg, x) -> dict:
    """Slots that differ between the two packages' ``cell_apply_raw`` on
    the finest level, from the JAX side's ``apply_c`` of x: its patch
    stencil and its singleton element GEMM apart."""
    jop, top = jmg.operators[-1], tmg.operators[-1]
    jc = jax.jit(lambda o, v: o.apply_c(v))(jop, jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(jax.jit(lambda o, v: o.cell_apply_raw(v))(jop, jc), np.float64)
    got = top.cell_apply_raw(torch.as_tensor(np.asarray(jc, np.float64), dtype=torch.bfloat16))
    diff = want != got.double().numpy()
    return {"fine stencil (patches)": int(diff[: top.patch_slots].sum()),
            "fine element GEMM (singletons)": int(diff[top.patch_slots:].sum())}


if __name__ == "__main__":
    import sys

    jax.config.update("jax_enable_x64", True)
    if len(sys.argv) > 1 and sys.argv[1] in ("stages", "stages-once"):
        bf16_stages(int(sys.argv[2]), once=sys.argv[1] == "stages-once")
    elif len(sys.argv) > 1 and sys.argv[1] == "counts":
        bf16_counts(refs=(int(sys.argv[2]),), jax_max_ref=int(sys.argv[2]))
    else:
        bf16_counts()
