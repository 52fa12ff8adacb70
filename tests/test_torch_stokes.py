"""The port's Stokes model, FGMRES and MINRES match the JAX package (CPU).

The divergence and pressure-mass matrices equal the JAX package's entry for
entry; ``gmres_solve`` takes the JAX solve's steps on a small nonsymmetric
system; the true-residual guard raises on a wrong solution; on the r=2
hypercube, block-diagonal MINRES and block-triangular FGMRES(30) take the
JAX package's iteration counts, and x agrees to 1e-8 once the JAX velocity
smoothers' Chebyshev intervals are copied in.  ``build_stokes`` leaves
TF32 off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.mesh.dof import distribute_dofs as jdofs
from dealii_multigrid_tpu.models import stokes as JS
from dealii_multigrid_tpu.solvers import gmres as JGM
from dealii_multigrid_tpu.utils.params import MultigridParameters as JMG
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.mesh.dof import distribute_dofs as tdofs
from dealii_multigrid_tpu_torch.models import stokes as TS
from dealii_multigrid_tpu_torch.solvers import gmres as TGM
from dealii_multigrid_tpu_torch.solvers.coarse import assemble_sparse_matrix
from dealii_multigrid_tpu_torch.utils.params import MultigridParameters as TMG

from test_torch_2d_solve import copy_intervals, rel


def mg_data(cls):
    mg = cls()
    mg.smoother.degree = 3
    mg.coarse_solver.type = "amg"
    return mg


@pytest.mark.parametrize("r", [1, 2])
def test_divergence_and_pressure_mass_equal_jax(r):
    jv, jp = jdofs(JG.create("hypercube", 3, r), 2), jdofs(JG.create("hypercube", 3, r), 1)
    tv, tp = tdofs(TG.create("hypercube", 3, r), 2), tdofs(TG.create("hypercube", 3, r), 1)
    w = np.random.default_rng(r).uniform(0.5, 2.0, tp.cell_dofs.shape[0])
    pairs = [
        (JS.assemble_divergence(jv, jp), TS.assemble_divergence(tv, tp)),
        (JS.assemble_pressure_mass(jp), TS.assemble_pressure_mass(tp)),
        (JS.assemble_pressure_mass(jp, w), TS.assemble_pressure_mass(tp, w)),
    ]
    for jm, tm in pairs:
        assert jm.shape == tm.shape
        assert np.array_equal(jm.indptr, tm.indptr) and np.array_equal(jm.indices, tm.indices)
        assert np.array_equal(jm.data, tm.data)


def test_cell_weights_scale_the_assembled_matrix():
    from dealii_multigrid_tpu_torch.mesh.dof import make_hanging_node_constraints

    dofh = tdofs(TG.create("hypercube", 3, 1), 2)
    hang = make_hanging_node_constraints(dofh)
    A1 = assemble_sparse_matrix(dofh, hang)
    A3 = assemble_sparse_matrix(dofh, hang, cell_weights=np.full(dofh.cell_dofs.shape[0], 3.0))
    free = ~dofh.boundary_mask
    d = (A3 - 3.0 * A1).toarray()[np.ix_(free, free)]
    assert np.abs(d).max() <= 1e-12 * np.abs(A1.toarray()).max()


def test_gmres_matches_jax_on_a_nonsymmetric_system():
    rng = np.random.default_rng(4)
    n = 80
    A = np.eye(n) * 4 + rng.standard_normal((n, n)) / np.sqrt(n)
    dinv = 1.0 / np.diag(A)
    b = rng.standard_normal(n)
    At, dt = torch.as_tensor(A), torch.as_tensor(dinv)
    tres = TGM.gmres_solve(lambda x: At @ x, torch.as_tensor(b), lambda r: dt * r,
                           m=10, maxiter=200, reltol=1e-10)
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    jres = jax.jit(lambda v: JGM.gmres_solve(lambda x: Aj @ x, v, lambda r: dj * r,
                                             m=10, maxiter=200, reltol=1e-10))(jnp.asarray(b))
    assert tres.converged and bool(jres.converged)
    assert tres.n_iterations == int(jres.n_iterations) and tres.n_iterations > 10  # restarted
    assert rel(tres.x, jres.x) <= 1e-10
    assert np.linalg.norm(A @ tres.x.numpy() - b) <= 1e-10 * np.linalg.norm(b)
    assert abs(tres.residual_norm - float(jres.residual_norm)) <= 1e-3 * float(jres.residual_norm)


def test_true_residual_guard():
    A = torch.diag(torch.arange(1.0, 11.0, dtype=torch.float64))

    class Op:
        dtype = torch.float64

        @staticmethod
        def vmult(x):
            return A @ x

    b = torch.ones(10, dtype=torch.float64)
    x = torch.linalg.solve(A, b)
    assert TGM.verify_true_residual(Op, b, x, 1e-12, 1e-8) <= 1e-12
    with pytest.raises(RuntimeError, match="disagrees"):
        TGM.verify_true_residual(Op, b, 1.5 * x, 1e-12, 1e-8)
    assert TGM.IdentityPreconditioner()(b) is b


@pytest.fixture(scope="module")
def stokes_pair():
    mesh_j, mesh_t = JG.create("hypercube", 3, 2, 0), TG.create("hypercube", 3, 2, 0)
    jop, jblock, _ = JS.build_stokes(mesh_j, mg_data(JMG), dtype=jnp.float64)
    torch.backends.cuda.matmul.allow_tf32 = True
    top, tblock, aux = TS.build_stokes(mesh_t, mg_data(TMG), device="cpu")
    tf32_after_build = torch.backends.cuda.matmul.allow_tf32
    # the JAX velocity smoothers' intervals (the start vectors differ)
    vp = tblock.v_precond
    jsm = jblock.v_precond.mg.smoothers
    vp = dataclasses.replace(vp, mg=dataclasses.replace(vp.mg, smoothers=copy_intervals(vp.mg.smoothers, jsm)))
    tblock = dataclasses.replace(tblock, v_precond=vp)
    b = np.random.default_rng(0).normal(size=3 * top.n_v + top.n_p)
    b[: 3 * top.n_v] *= top.keep_v.numpy()
    b[3 * top.n_v:] -= b[3 * top.n_v:].mean()
    return (jop, jblock), (top, tblock, aux), b, tf32_after_build


def test_build_stokes_turns_tf32_off(stokes_pair):
    *_, tf32_after_build = stokes_pair
    assert tf32_after_build is False


def test_stokes_operator_matches_jax(stokes_pair):
    (jop, jblock), (top, tblock, aux), b, _ = stokes_pair
    assert (top.n_v, top.n_p) == (jop.n_v, jop.n_p) == (729, 125)
    assert top.B.vals.device.type == "cpu" and top.keep_v.dtype == torch.float64
    x = np.random.default_rng(2).standard_normal(b.shape[0])
    assert rel(top.vmult(torch.as_tensor(x)), jax.jit(lambda o, v: o.vmult(v))(jop, jnp.asarray(x))) <= 1e-12
    jz = jax.jit(lambda p, v: p.vmult(v))(jblock, jnp.asarray(b))
    assert rel(tblock.vmult(torch.as_tensor(b)), jz) <= 1e-10
    y = TS.project_pressure_mean(torch.as_tensor(x), top.n_v, top.n_p)
    assert abs(float(y[3 * top.n_v:].mean())) <= 1e-14
    assert torch.equal(y[: 3 * top.n_v], torch.as_tensor(x[: 3 * top.n_v]))


def test_vector_operator_and_preconditioner_match_jax(stokes_pair):
    from dealii_multigrid_tpu.ops import vector as JV
    from dealii_multigrid_tpu_torch.ops import vector as TV

    (jop, jblock), (top, tblock, _), _, _ = stokes_pair
    u = np.random.default_rng(3).standard_normal((3, top.n_v))
    w = np.random.default_rng(4).standard_normal((3, top.n_v))
    tv, jv = TV.make_vector_operator(top.a_op.scalar, 3), JV.make_vector_operator(jop.a_op.scalar, 3)
    assert tv.n_dofs == jv.n_dofs == 3 * top.n_v
    ut, uj = torch.as_tensor(u), jnp.asarray(u)
    assert rel(tv.vmult(ut), jax.jit(lambda o, v: o.vmult(v))(jv, uj)) <= 1e-12
    assert abs(float(tv.dot(ut, torch.as_tensor(w))) - float((u * w).sum())) <= 1e-12 * np.abs(u * w).sum()
    tp, jp = TV.VectorPreconditioner(tblock.v_precond), JV.VectorPreconditioner(jblock.v_precond)
    assert rel(tp.vmult(ut), jax.jit(lambda p, v: p.vmult(v))(jp, uj)) <= 1e-10


def test_stokes_minres_and_fgmres_match_jax(stokes_pair):
    (jop, jblock), (top, tblock, _), b, _ = stokes_pair
    bt, bj = torch.as_tensor(b), jnp.asarray(b)
    # block-diagonal MINRES
    tx, tit, _ = TS.minres_solve(top.vmult, bt, tblock.vmult, maxiter=500, reltol=1e-8)
    jx, jit, _ = jax.jit(lambda o, p, v: JS.minres_solve(o.vmult, v, p.vmult, maxiter=500,
                                                         reltol=1e-8))(jop, jblock, bj)
    assert tit == int(jit) and rel(tx, jx) <= 1e-8
    # block-triangular FGMRES(30)
    ttri, jtri = TS.triangular_preconditioner(top, tblock), JS.triangular_preconditioner(jop, jblock)
    tres = TGM.gmres_solve(top.vmult, bt, ttri.vmult, m=30, maxiter=200, reltol=1e-8)
    jres = jax.jit(lambda o, p, v: JGM.gmres_solve(o.vmult, v, p.vmult, m=30, maxiter=200,
                                                   reltol=1e-8))(jop, jtri, bj)
    assert tres.converged and tres.n_iterations == int(jres.n_iterations) < tit
    assert rel(tres.x, jres.x) <= 1e-8
    true = TGM.verify_true_residual(top, bt, tres.x, tres.residual_norm, 1e-8)
    assert true <= 1e-8 * np.linalg.norm(b)
