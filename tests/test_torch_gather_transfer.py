"""The port's gather-engine transfers match the JAX package (CPU, float64).

``TwoLevelTransfer`` (h and p, 2D and 3D) and the local-smoothing
``LSTransfer`` prolong and restrict like the JAX package's to 1e-12
relative; the port's transfers are adjoint and interpolate exactly, as
tests/test_transfer.py holds the JAX ones.  Every fixed-order sum table
(ops/fixed_order.py) gives the ``index_add_`` result to 1e-14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence as jcoarsen
from dealii_multigrid_tpu.ops.transfer import make_two_level_transfer as jtransfer
from dealii_multigrid_tpu.solvers import local_smoothing as JLS
from dealii_multigrid_tpu.utils.params import MultigridParameters as JMG
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence as tcoarsen
from dealii_multigrid_tpu_torch.ops.fixed_order import FixedOrderSum
from dealii_multigrid_tpu_torch.ops.hybrid_transfer import make_hybrid_transfer
from dealii_multigrid_tpu_torch.ops.transfer import make_two_level_transfer
from dealii_multigrid_tpu_torch.solvers import local_smoothing as TLS
from dealii_multigrid_tpu_torch.utils.params import MultigridParameters as TMG

CPU = torch.device("cpu")
TOL = 1e-12
# the JAX side as one compiled program per call (faster than op by op)
jprolong = jax.jit(lambda t, u: t.prolong(u))
jrestrict = jax.jit(lambda t, u: t.restrict(u))
jvmult = jax.jit(lambda op, u: op.vmult(u))
R = {2: 4, 3: 3}   # refinements per dimension: a few hundred to a few thousand DoFs


def plan(kind, dim, G, coarsen, p=2):
    """(fine mesh, fine degree), (coarse mesh, coarse degree)."""
    mesh = G.create("quadrant", dim, R[dim])
    if kind == "h":
        seq = coarsen(mesh)
        return (seq[-1], p), (seq[-2], p)
    return (mesh, p), (mesh, 1)


def pair(kind, dim):
    (fm, fp), (cm, cp) = plan(kind, dim, JG, jcoarsen)
    jf, jc = japi.build_level(fm, fp, jnp.float64), japi.build_level(cm, cp, jnp.float64)
    jt = jtransfer(jf.dofh, jc.dofh, jf.op, jc.op, dtype=jnp.float64)
    (fm, fp), (cm, cp) = plan(kind, dim, TG, tcoarsen)
    tf = tapi.build_level(fm, fp, CPU, torch.float64)
    tc = tapi.build_level(cm, cp, CPU, torch.float64)
    tt = make_two_level_transfer(tf.dofh, tc.dofh, tf.op, tc.op, dtype=torch.float64)
    return (jf, jc, jt), (tf, tc, tt)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["h", "p"])
def test_two_level_transfer_matches_jax(kind, dim):
    (jf, jc, jt), (tf, tc, tt) = pair(kind, dim)
    rng = np.random.default_rng(7)
    uc = rng.standard_normal(jc.dofh.n_dofs)
    rf = rng.standard_normal(jf.dofh.n_dofs)
    assert rel(tt.prolong(torch.as_tensor(uc)), jprolong(jt, jnp.asarray(uc))) <= TOL
    assert rel(tt.restrict(torch.as_tensor(rf)), jrestrict(jt, jnp.asarray(rf))) <= TOL
    assert len(tt.buckets) == len(jt.buckets)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["h", "p"])
def test_transfer_adjoint_and_exact_interpolation(kind, dim):
    """<P u_c, r_f> = <u_c, R r_f>; prolongating the coarse interpolant of a
    multilinear function reproduces its fine interpolant away from the
    constrained DoFs and the cells whose coarse source touches the boundary
    (tests/test_transfer.py)."""
    (fm, fp), (cm, cp) = plan(kind, dim, TG, tcoarsen)
    fine = tapi.build_level(fm, fp, CPU, torch.float64)
    coarse = tapi.build_level(cm, cp, CPU, torch.float64)
    tr = make_two_level_transfer(fine.dofh, coarse.dofh, fine.op, coarse.op, torch.float64)
    rng = np.random.default_rng(1)
    uc = torch.as_tensor(rng.standard_normal(coarse.dofh.n_dofs))
    rf = torch.as_tensor(rng.standard_normal(fine.dofh.n_dofs))
    lhs, rhs = float(tr.prolong(uc) @ rf), float(uc @ tr.restrict(rf))
    assert abs(lhs - rhs) < 1e-12 * max(abs(lhs), 1.0)

    def f(x):
        return np.prod([1 + (d + 1) * x[:, d] for d in range(dim)], axis=0)

    uf = tr.prolong(torch.as_tensor(f(coarse.dofh.points))).numpy()
    mask = np.ones(fine.dofh.n_dofs, bool)
    mask[fine.op.constrained.numpy()] = False
    excluded = coarse.dofh.boundary_mask.copy()
    ch = coarse.op.hanging
    if ch.slave.numel():
        bad = (excluded[ch.masters.numpy()] & (ch.weights.numpy() != 0)).any(1)
        excluded[ch.slave.numpy()[bad]] = True
    for b in tr.buckets:
        touches = excluded[b.coarse_dofs.numpy()].any(axis=1)
        mask[b.fine_dofs.numpy()[touches].reshape(-1)] = False
    assert mask.sum() > 0
    assert np.abs(uf - f(fine.dofh.points))[mask].max() < 1e-11
    # constrained fine DoFs stay zero
    assert not tr.prolong(torch.ones(coarse.dofh.n_dofs, dtype=torch.float64))[
        fine.op.constrained
    ].any()


def test_ls_transfer_matches_jax():
    mesh_j, mesh_t = JG.create("quadrant", 2, 3), TG.create("quadrant", 2, 3)
    from dealii_multigrid_tpu.mesh.dof import distribute_dofs as jdofs
    from dealii_multigrid_tpu_torch.mesh.dof import distribute_dofs as tdofs

    jmg = JLS.build_local_smoothing_mg(jdofs(mesh_j, 2), JMG(), dtype=jnp.float64)
    tmg = TLS.build_local_smoothing_mg(tdofs(mesh_t, 2), TMG(), CPU, torch.float64)
    assert len(tmg.levels) == len(jmg.levels) == 4
    rng = np.random.default_rng(3)
    for jt, tt in zip(jmg.transfers[1:], tmg.transfers[1:]):
        uc, rf = rng.standard_normal(jt.n_c), rng.standard_normal(jt.n_f)
        assert rel(tt.prolong(torch.as_tensor(uc)), jprolong(jt, jnp.asarray(uc))) <= TOL
        assert rel(tt.restrict(torch.as_tensor(rf)), jrestrict(jt, jnp.asarray(rf))) <= TOL
    for jl, tl in zip(jmg.levels, tmg.levels):
        u = rng.standard_normal(jl.n_dofs)
        assert rel(tl.vmult(torch.as_tensor(u)), jvmult(jl, jnp.asarray(u))) <= TOL
        assert np.array_equal(tl.keep.numpy(), np.asarray(jl.keep))


def site_tables():
    """(name, FixedOrderSum, target of every source) of every fixed-order
    table a small 2D gather hierarchy and a small 3D hybrid one build."""
    out = []
    (fm, p), (cm, _) = plan("h", 2, TG, tcoarsen)
    fine, coarse = (tapi.build_level(m, p, CPU, torch.float64) for m in (fm, cm))
    tr = make_two_level_transfer(fine.dofh, coarse.dofh, fine.op, coarse.op, torch.float64)
    out.append(("cell", fine.op.cell_sum, fine.dofh.cell_dofs))
    ch = fine.op.hanging
    out.append(("masters", ch.master_sum,
                np.where(ch.weights.numpy() != 0, ch.masters.numpy(), -1)))  # -1: padding
    out.append(("prolong", tr.prolong_sum, torch.cat([b.fine_dofs.reshape(-1) for b in tr.buckets])))
    out.append(("restrict", tr.restrict_sum, torch.cat([b.coarse_dofs.reshape(-1) for b in tr.buckets])))
    ls = TLS.build_local_smoothing_mg(fine.dofh, TMG(), CPU, torch.float64)
    lt = ls.transfers[-1]
    out.append(("ls_prolong", lt.prolong_sum, torch.cat([fd.reshape(-1) for fd, _, _ in lt.buckets])))
    out.append(("ls_restrict", lt.restrict_sum, torch.cat([cd.reshape(-1) for _, cd, _ in lt.buckets])))
    seq = tcoarsen(TG.create("quadrant", 3, 2))
    hc, hf = (tapi.build_level_hybrid(m, 2, CPU, torch.float64) for m in seq[-2:])
    from dealii_multigrid_tpu_torch.ops.hybrid_format import hybrid_operator_tables
    tables, meta = hybrid_operator_tables(hf.fmt, hf.hanging)
    rounds = meta["sf_ct_rounds"] or tuple((i,) for i in range(len(meta["sf_levels"]) - 1, -1, -1))
    for k, (rnd, s) in enumerate(zip(rounds, hf.op.ct_face_sums)):
        tgt = np.concatenate([
            np.asarray(part[1]).reshape(-1) for i in rnd
            for part in (tables["sf_patch"][i], tables["sf_single"][i]) if part is not None
        ])
        out.append((f"ct_faces{k}", s, tgt))
    htr = make_hybrid_transfer(hf.fmt, hc.fmt, hf.op, hc.op)
    from dealii_multigrid_tpu_torch.ops.hybrid_transfer import hybrid_transfer_tables
    ttab, _ = hybrid_transfer_tables(hf.fmt, hc.fmt)
    tgt = [np.asarray(s).reshape(-1) for _, s, _ in ttab["single_buckets"]]
    tgt += [
        (hc.op.patch_slots + np.asarray(c)[:, None] * M.shape[1] + np.arange(M.shape[1])).reshape(-1)
        for _, c, M in ttab["single_fast"]
    ]
    for key in ("irr_id", "irr_patch"):
        if ttab[key] is not None:
            tgt.insert(0, np.asarray(ttab[key][1]).reshape(-1))
    out.append(("hybrid_restrict", htr.restrict_sum, np.concatenate(tgt)))
    return out


def test_fixed_order_tables_equal_index_add():
    """Each site's table against ``index_add_`` of the same sources, in
    float64, into zeros and onto a base vector; and a random table with
    duplicates, sparse targets and a trailing dimension."""
    rng = np.random.default_rng(11)
    cases = site_tables()
    tgt = rng.integers(-5, 50, 400)     # some dropped sources, sparse targets
    cases.append(("random", FixedOrderSum.build(tgt, 80, CPU), tgt))
    full = np.repeat(np.arange(30), 3)  # every row full: no appended zero
    cases.append(("full", FixedOrderSum.build(full, 30, CPU), full))
    names = set()
    for name, table, target in cases:
        target = torch.as_tensor(np.asarray(target), dtype=torch.int64).reshape(-1)
        trail = (3,) if name in ("random", "full") else ()
        src = torch.as_tensor(rng.standard_normal((target.numel(),) + trail))
        live = target >= 0
        ref = torch.zeros((table.n_target,) + trail, dtype=torch.float64).index_add_(
            0, target[live], src[live])
        scale = float(ref.abs().max())
        assert float((table.scatter(src) - ref).abs().max()) <= 1e-14 * scale, name
        base = torch.as_tensor(rng.standard_normal((table.n_target,) + trail))
        got = table.add_into(base.clone(), src)
        assert float((got - (base + ref)).abs().max()) <= 1e-14 * max(scale, 1.0), name
        assert table.width >= 1 and table.nbytes > 0
        names.add(name)
    assert {"cell", "prolong", "restrict", "ls_restrict", "ct_faces0", "hybrid_restrict"} <= names
    assert FixedOrderSum.build(full, 30, CPU).full and not FixedOrderSum.build(tgt, 80, CPU).full


@pytest.mark.parametrize("simulation_type", ["Constant", "Gaussian"])
def test_hybrid_rhs_equals_gather_rhs(simulation_type):
    """The hybrid engine's right-hand side (cell integrals summed into the
    slots on the host, in one fixed order) equals the gather engine's
    (fixed-order table) on the same 3D mesh, float64, to 1e-13."""
    from dealii_multigrid_tpu_torch.models import poisson
    from dealii_multigrid_tpu_torch.ops.hybrid_format import cell_slot_table

    mesh = tcoarsen(TG.create("quadrant", 3, 3))[-1]
    hyb = tapi.build_level_hybrid(mesh, 2, CPU, torch.float64)
    gat = tapi.build_level(mesh, 2, CPU, torch.float64)
    hp, _ = poisson.assemble_problem_hybrid(
        hyb.dofh, hyb.hanging, hyb.op, cell_slot_table(hyb.fmt), hyb.fmt, simulation_type)
    gp = poisson.make_problem(gat.dofh, gat.hanging, gat.op, simulation_type)
    assert np.array_equal(hyb.dofh.cell_dofs, gat.dofh.cell_dofs)
    assert rel(hp.rhs, gp.rhs) <= 1e-13
    assert np.abs(hp.lift - gp.lift).max() <= 1e-13 * max(np.abs(gp.lift).max(), 1.0)
