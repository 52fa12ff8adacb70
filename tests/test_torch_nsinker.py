"""The port's n-sinker Stokes model matches the JAX package (CPU, float64).

``make_operator(cell_weights=)`` applies as JAX's to 1e-13; the viscosity
field is bit-equal; the prolongation, the Galerkin level matrices and the
transfer tables are equal entry for entry; unit viscosity reproduces
``build_stokes``'s operator; one application of the block-triangular
preconditioner agrees to 1e-10 for mean/mass and galerkin/wbfbt at r=2 once
the JAX velocity smoothers' Chebyshev intervals are copied in, and without
the copy the port's own velocity intervals equal the JAX package's to 1e-9
relative (both start the eigenvalue estimates from
``jax.random.normal(PRNGKey(42))``); FGMRES(30) at contrast 1e4
takes JAX's iteration count with x to 1e-6; the rebuilder's operator and
preconditioner match JAX's for one viscosity field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.models import nsinker as JN, stokes as JS
from dealii_multigrid_tpu.ops import operator as JO
from dealii_multigrid_tpu.solvers import gmres as JGM
from dealii_multigrid_tpu.utils.params import MultigridParameters as JMG
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.models import nsinker as TN, stokes as TS
from dealii_multigrid_tpu_torch.ops import operator as TO
from dealii_multigrid_tpu_torch.solvers import gmres as TGM
from dealii_multigrid_tpu_torch.utils.params import MultigridParameters as TMG

from test_torch_2d_solve import INTERVAL_BOUND, copy_intervals, interval_gaps, rel
from test_torch_amg import same_ell

CASES = {"mean/mass": ("mean", "mass", 1e2, 1), "galerkin/wbfbt": ("galerkin", "wbfbt", 1e4, 0)}


def mg_data(cls):
    mg = cls()
    mg.smoother.degree = 3
    mg.coarse_solver.type = "amg"
    return mg


def with_jax_intervals(block, jblock):
    """The port's block preconditioner with the JAX velocity smoothers'
    Chebyshev intervals."""
    mg = block.v_precond.mg
    mg = dataclasses.replace(mg, smoothers=copy_intervals(mg.smoothers, jblock.v_precond.mg.smoothers))
    return dataclasses.replace(block, v_precond=dataclasses.replace(block.v_precond, mg=mg))


def saddle_rhs(op, seed: int) -> np.ndarray:
    b = np.random.default_rng(seed).normal(size=3 * op.n_v + op.n_p)
    b[: 3 * op.n_v] *= np.asarray(op.keep_v)
    b[3 * op.n_v:] -= b[3 * op.n_v:].mean()
    return b


def build_port(name):
    """The port's op/block/aux at hypercube r=2, with its own intervals."""
    coarsening, schur, contrast, seed = CASES[name]
    tv = TN.nsinker_viscosity(n_sinkers=4, eta_max=contrast, seed=seed)
    return TN.build_stokes_nsinker(TG.create("hypercube", 3, 2, 0), mg_data(TMG), tv,
                                   coarsening=coarsening, schur=schur, device="cpu")


def build_pair(name):
    """(name, JAX op/block/aux, port op/block/aux) at hypercube r=2."""
    coarsening, schur, contrast, seed = CASES[name]
    jv = JN.nsinker_viscosity(n_sinkers=4, eta_max=contrast, seed=seed)
    j = JN.build_stokes_nsinker(JG.create("hypercube", 3, 2, 0), mg_data(JMG), jv, dtype=jnp.float64,
                                coarsening=coarsening, schur=schur)
    t = build_port(name)
    return name, j, (t[0], with_jax_intervals(t[1], j[1]), t[2])


@pytest.fixture(scope="module")
def mean_pair():
    return build_pair("mean/mass")


@pytest.fixture(scope="module")
def galerkin_pair():
    return build_pair("galerkin/wbfbt")


@pytest.fixture(params=list(CASES))
def pair(request):
    return request.getfixturevalue("mean_pair" if request.param == "mean/mass" else "galerkin_pair")


def test_make_operator_cell_weights_matches_jax():
    jd, td = (D.distribute_dofs(G.create("hypercube", 3, 2, 0), 2) for D, G in ((JD, JG), (TD, TG)))
    rng = np.random.default_rng(5)
    w = np.exp(rng.normal(size=td.cell_dofs.shape[0]))
    x = rng.standard_normal(td.n_dofs)
    jop = JO.make_operator(jd, JD.make_hanging_node_constraints(jd), dtype=jnp.float64, cell_weights=w)
    top = TO.make_operator(td, TD.make_hanging_node_constraints(td), "cpu", torch.float64, cell_weights=w)
    y = top.vmult(torch.as_tensor(x))
    assert rel(y, jax.jit(lambda o, v: o.vmult(v))(jop, jnp.asarray(x))) <= 1e-13
    unweighted = TO.make_operator(td, TD.make_hanging_node_constraints(td), "cpu", torch.float64)
    assert rel(y, unweighted.vmult(torch.as_tensor(x))) > 1e-2  # the weights act


def test_viscosity_is_bit_equal():
    pts = np.random.default_rng(6).uniform(-1, 1, size=(500, 3))
    for seed in (0, 1):
        j = JN.nsinker_viscosity(n_sinkers=4, eta_max=1e6, seed=seed)
        t = TN.nsinker_viscosity(n_sinkers=4, eta_max=1e6, seed=seed)
        assert np.array_equal(j.centers, t.centers)
        assert np.array_equal(j(pts), t(pts))


def test_prolongation_equals_jax():
    from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence as jseq
    from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence as tseq

    jm, tm = jseq(JG.create("hypercube", 3, 2, 0)), tseq(TG.create("hypercube", 3, 2, 0))
    for l in (1, 2):
        Pj = JN.assemble_prolongation(JD.distribute_dofs(jm[l], 2), JD.distribute_dofs(jm[l - 1], 2))
        Pt = TN.assemble_prolongation(TD.distribute_dofs(tm[l], 2), TD.distribute_dofs(tm[l - 1], 2))
        assert Pj.shape == Pt.shape
        assert np.array_equal(Pj.indptr, Pt.indptr) and np.array_equal(Pj.indices, Pt.indices)
        assert np.array_equal(Pj.data, Pt.data)


def test_galerkin_levels_and_transfers_equal_jax(galerkin_pair):
    _, (jop, jblock, _), (top, tblock, _) = galerkin_pair
    jmg, tmg = jblock.v_precond.mg, tblock.v_precond.mg
    assert len(tmg.operators) == len(jmg.operators) == 3
    for l in range(len(tmg.operators) - 1):
        same_ell(tmg.operators[l].M, jmg.operators[l].M)
    for l in range(1, len(tmg.operators)):
        same_ell(tmg.transfers[l].P, jmg.transfers[l].P)
        same_ell(tmg.transfers[l].Pt, jmg.transfers[l].Pt)
    assert rel(tmg.coarse_solve.L, jmg.coarse_solve.L) <= 1e-14
    for ts, js in zip(tmg.smoothers[1:], jmg.smoothers[1:]):
        assert np.array_equal(ts.inv_diag.numpy(), np.asarray(js.inv_diag))
        assert abs(ts.theta - js.theta) <= 0.1 * js.theta  # the copied intervals
    # every Galerkin table is on the caller's device
    assert all(op.M.vals.device.type == "cpu" for op in tmg.operators[:-1])


def test_unit_viscosity_reproduces_build_stokes():
    mesh = TG.create("hypercube", 3, 2, 0)
    op_c, _, _ = TS.build_stokes(mesh, mg_data(TMG), device="cpu")
    op_v, _, aux = TN.build_stokes_nsinker(mesh, mg_data(TMG), lambda x: np.ones(x.shape[0]),
                                           device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(size=3 * op_c.n_v + op_c.n_p))
    ya, yb = op_c.vmult(x), op_v.vmult(x)
    assert float((ya - yb).abs().max()) < 1e-11 * float(ya.abs().max())
    assert aux["eta_fine"].shape == (mesh.n_cells,) and set(aux["setup_seconds"]) >= {"levels", "divergence"}


def test_operator_and_triangular_preconditioner_match_jax(pair):
    name, (jop, jblock, jaux), (top, tblock, taux) = pair
    assert (top.n_v, top.n_p) == (jop.n_v, jop.n_p) == (729, 125)
    assert np.array_equal(taux["eta_fine"], jaux["eta_fine"])
    x = np.random.default_rng(2).standard_normal(3 * top.n_v + top.n_p)
    assert rel(top.vmult(torch.as_tensor(x)), jax.jit(lambda o, v: o.vmult(v))(jop, jnp.asarray(x))) <= 1e-12
    ttri, jtri = TS.triangular_preconditioner(top, tblock), JS.triangular_preconditioner(jop, jblock)
    b = saddle_rhs(top, 3)
    assert rel(ttri.vmult(torch.as_tensor(b)), jax.jit(lambda p, v: p.vmult(v))(jtri, jnp.asarray(b))) <= 1e-10


def test_velocity_intervals_are_the_ports_own_and_match_jax(pair):
    name, (_, jblock, _), _ = pair
    own = build_port(name)[1]
    gaps = interval_gaps(own.v_precond.mg.smoothers, jblock.v_precond.mg.smoothers)
    assert len(gaps) >= 1 and max(gaps) <= INTERVAL_BOUND[torch.float64], (name, gaps)


def test_fgmres_matches_jax(galerkin_pair):
    _, (jop, jblock, _), (top, tblock, _) = galerkin_pair
    b = saddle_rhs(top, 1)
    ttri, jtri = TS.triangular_preconditioner(top, tblock), JS.triangular_preconditioner(jop, jblock)
    tres = TGM.gmres_solve(top.vmult, torch.as_tensor(b), ttri.vmult, m=30, maxiter=150, reltol=1e-8)
    jres = jax.jit(lambda o, p, v: JGM.gmres_solve(o.vmult, v, p.vmult, m=30, maxiter=150,
                                                   reltol=1e-8))(jop, jtri, jnp.asarray(b))
    assert tres.converged and bool(jres.converged)
    assert tres.n_iterations == int(jres.n_iterations)
    assert rel(tres.x, jres.x) <= 1e-6
    true = TGM.verify_true_residual(top, torch.as_tensor(b), tres.x, tres.residual_norm, 1e-8)
    assert true <= 1e-8 * np.linalg.norm(b) * 10


def test_wbfbt_with_a_multilevel_kp_amg_matches_jax(galerkin_pair):
    """Up to 800 rows (r <= 3) the Kp AMG is one dense level; from r=4 on it
    runs its V-cycle.  With the coarse size lowered to 5, r=2's Kp AMG has
    three levels (as r=5's has), and one w-BFBT application through it
    agrees with JAX's to 1e-10."""
    from dealii_multigrid_tpu.solvers import amg as JA
    from dealii_multigrid_tpu_torch.solvers import amg as TA

    _, (_, jblock, _), (_, tblock, taux) = galerkin_pair
    js, ts = jblock.p_solve, tblock.p_solve
    assert np.array_equal(ts.dinv.numpy(), np.asarray(js.dinv))
    B = taux["B"]
    Kp = (B @ sp.diags(ts.dinv.numpy()) @ B.T).tocsr()
    A = (Kp + 1e-10 * float(np.abs(Kp.diagonal()).max()) * sp.eye(Kp.shape[0])).tocsr()
    A.sort_indices()  # a build sorts them in place: both start from one order
    jamg = JA.build_amg(A, dtype=jnp.float64, n_cycles=1, coarse_size=5)
    tamg = TA.build_amg(A, dtype=torch.float64, device="cpu", n_cycles=1, coarse_size=5)
    assert [d["rows"] for d in tamg.describe()] == [lev.A.shape[0] for lev in jamg.levels] == [125, 9, 4]
    for tl, jl in zip(tamg.levels, jamg.levels):
        same_ell(tl.A, jl.A)
    js = dataclasses.replace(js, kp_solve=dataclasses.replace(js.kp_solve, amg=jamg))
    ts = dataclasses.replace(ts, kp_solve=dataclasses.replace(ts.kp_solve, amg=tamg))
    r = np.random.default_rng(9).standard_normal(125)
    y = ts.vmult(torch.as_tensor(r))
    assert rel(y, jax.jit(lambda p, v: p.vmult(v))(js, jnp.asarray(r))) <= 1e-10
    assert rel(y, tblock.p_solve.vmult(torch.as_tensor(r))) > 1e-8  # the V-cycle acts


def test_rebuilder_matches_jax():
    rng = np.random.default_rng(8)
    jmesh, tmesh = JG.create("hypercube", 3, 2, 0), TG.create("hypercube", 3, 2, 0)
    eta = np.exp(rng.normal(size=tmesh.n_cells))
    jop, jblock = JN.make_stokes_rebuilder(jmesh, mg_data(JMG), jnp.float64)(eta)
    rebuild = TN.make_stokes_rebuilder(tmesh, mg_data(TMG), device="cpu")
    top, tblock = rebuild(eta)
    tblock = with_jax_intervals(tblock, jblock)
    assert rebuild.dofh_v.n_dofs == top.n_v and rebuild.dofh_p.n_dofs == top.n_p
    x = rng.standard_normal(3 * top.n_v + top.n_p)
    assert rel(top.vmult(torch.as_tensor(x)), jax.jit(lambda o, v: o.vmult(v))(jop, jnp.asarray(x))) <= 1e-12
    assert rel(tblock.vmult(torch.as_tensor(x)), jax.jit(lambda p, v: p.vmult(v))(jblock, jnp.asarray(x))) <= 1e-10
    # a second viscosity on the same geometry moves the operator
    top2, _ = rebuild(2.0 * eta)
    y1, y2 = top.a_op.vmult(torch.as_tensor(x[: 3 * top.n_v]).view(3, -1)), top2.a_op.vmult(
        torch.as_tensor(x[: 3 * top.n_v]).view(3, -1))
    free = torch.as_tensor(~rebuild.dofh_v.boundary_mask)
    assert torch.allclose(y2[:, free], 2.0 * y1[:, free], rtol=1e-12, atol=0)


def nsinker_spread(rows=((3, 64), (4, 0)), jax_intervals: bool = False) -> None:
    """FGMRES(30) counts of the record's n-sinker system (galerkin/wbfbt,
    4 sinkers, seed 0, contrast 1e6, float64, to 1e-8; results/
    stokes-nsinker-tpu.txt:11) in the JAX package (its host-restart GMRES,
    as scripts/profile_stokes_tpu.py solves) and in the port, both on the
    CPU: for each (r, k) of ``rows``, at refinement r from the record's
    right-hand side and from k changes of it at the level of roundoff
    (``chip_smoke.stokes_rhs``, which phase u runs on the card); by default
    r=3 with 64 changes and r=4 alone.

        PYTHONPATH=. python tests/test_torch_nsinker.py

    ``... tests/test_torch_nsinker.py r5 [K]`` runs r=5 alone (859,812 DoFs,
    the row chip_smoke.py phase u solves on the card) with K changes of b
    (default none; about 7 minutes per solve and package on 8 cores): 108
    iterations in both packages from the record's b and two changes of it;
    ``r5-intervals`` adds, from the record's b, the port's solve with the
    JAX package's velocity Chebyshev intervals copied in, which takes the
    count of the port's own intervals (both packages start the eigenvalue
    estimates from ``jax.random.normal(PRNGKey(42))``, the port through
    ``utils.threefry``).
    """
    import chip_smoke
    from dealii_multigrid_tpu.solvers.gmres import gmres_solve_host

    for r, n_perturbations in rows:
        jop, jblock, _ = JN.build_stokes_nsinker(
            JG.create("hypercube", 3, r, 0), mg_data(JMG),
            JN.nsinker_viscosity(n_sinkers=4, eta_max=1e6, seed=0), dtype=jnp.float64,
            coarsening="galerkin", schur="wbfbt")
        top, tblock, _ = TN.build_stokes_nsinker(
            TG.create("hypercube", 3, r, 0), mg_data(TMG),
            TN.nsinker_viscosity(n_sinkers=4, eta_max=1e6, seed=0),
            coarsening="galerkin", schur="wbfbt", device="cpu")
        jtri, ttri = JS.triangular_preconditioner(jop, jblock), TS.triangular_preconditioner(top, tblock)
        counts = {"jax": [], "port": []}
        if jax_intervals:
            itri = TS.triangular_preconditioner(top, with_jax_intervals(tblock, jblock))
            counts["port, JAX intervals"] = []
        for k in range(n_perturbations + 1):
            b = chip_smoke.stokes_rhs(top, draw=1, perturbation=k)
            jres = gmres_solve_host(jop, jnp.asarray(b.numpy()), preconditioner=jtri, m=30,
                                    reltol=1e-8, maxiter=300)
            tres = TGM.gmres_solve(top.vmult, b, ttri.vmult, m=30, maxiter=300, reltol=1e-8)
            solved = [
                ("jax", jres, JGM.verify_true_residual(jop, jnp.asarray(b.numpy()), jres.x,
                                                       jres.residual_norm, 1e-8)),
                ("port", tres, TGM.verify_true_residual(top, b, tres.x, tres.residual_norm, 1e-8)),
            ]
            if jax_intervals:
                ires = TGM.gmres_solve(top.vmult, b, itri.vmult, m=30, maxiter=300, reltol=1e-8)
                solved.append(("port, JAX intervals", ires, TGM.verify_true_residual(
                    top, b, ires.x, ires.residual_norm, 1e-8)))
            for name, res, true in solved:
                counts[name].append(int(res.n_iterations))
                print(f"r={r} {'record b' if k == 0 else f'perturbation {k}'} {name}: "
                      f"{int(res.n_iterations)} iterations, converged {bool(res.converged)}, true "
                      f"relative residual {float(true) / float(torch.linalg.norm(b)):.3e}", flush=True)
        print(f"r={r} contrast 1e6 counts: {counts}", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import sys

    if sys.argv[1:2] == ["r5"]:
        nsinker_spread(((5, int(sys.argv[2]) if len(sys.argv) > 2 else 0),))
    elif sys.argv[1:2] == ["r5-intervals"]:
        nsinker_spread(((5, 0),), jax_intervals=True)
    else:
        nsinker_spread()
