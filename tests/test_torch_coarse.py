"""The port's coarse-solver types and gather-engine operator against the JAX
package (CPU, float64).

``LaplaceOperator.vmult`` and the assembled problem must agree to 1e-12; an
HMG-global solve with each of the five coarse-solver types (and "direct")
must take the JAX run's iteration count and agree in x to 1e-8 relative;
``cg_with_chebyshev``'s Chebyshev interval, estimated from
``jax.random.normal(PRNGKey(42))`` in both packages, equals JAX's to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.models import poisson as jpoisson
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.models import poisson as tpoisson
from dealii_multigrid_tpu_torch.solvers import coarse as tcoarse
from dealii_multigrid_tpu_torch.solvers.amg import AMGPreconditioner
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams

CPU = torch.device("cpu")


def params(cls, mg_type, r, p, coarse="amg", dim=3):
    prm = cls()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.dim = dim
    prm.number_type = "double"
    prm.mg_number_type = "double"
    prm.mg_data.coarse_solver.type = coarse
    prm.mg_data.smoother.degree = 3
    prm.mg_data.n_repetitions = 1
    return prm


def levels(dim, r, p):
    jl = japi.build_level(JG.create("quadrant", dim, r), p, jnp.float64)
    tl = tapi.build_level(TG.create("quadrant", dim, r), p, CPU, torch.float64)
    return jl, tl


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dim,r,p", [(3, 3, 2), (3, 2, 4), (2, 4, 3)])
def test_laplace_operator_vmult_matches_jax(dim, r, p):
    jl, tl = levels(dim, r, p)
    assert tl.dofh.n_dofs == jl.dofh.n_dofs == tl.op.n_dofs
    assert tl.op.hanging.slave.shape[0] > 0          # hanging nodes are exercised
    u = np.random.default_rng(3).standard_normal(tl.dofh.n_dofs)
    tu, ju = torch.as_tensor(u), jnp.asarray(u)
    assert rel(tl.op.vmult(tu), jl.op.vmult(ju)) <= 1e-12
    assert rel(tl.op.apply_c(tu), jl.op.apply_c(ju)) <= 1e-12
    assert rel(tl.op.apply_ct(tu), jl.op.apply_ct(ju)) <= 1e-12
    assert rel(tl.inv_diag, jl.inv_diag) <= 1e-14
    assert torch.equal(tu, torch.as_tensor(u))        # the input is not written


@pytest.mark.parametrize("sim", ["Constant", "Gaussian"])
def test_gather_problem_matches_jax(sim):
    jl, tl = levels(3, 3, 2)
    jp = jpoisson.make_problem(jl.dofh, jl.hanging, jl.op, sim)
    tp = tpoisson.make_problem(tl.dofh, tl.hanging, tl.op, sim)
    assert rel(tp.rhs, jp.rhs) <= 1e-12
    assert np.abs(tp.lift - np.asarray(jp.lift)).max() <= 1e-14
    u = np.random.default_rng(4).standard_normal(tl.dofh.n_dofs)
    full = tp.full_solution(torch.as_tensor(u))
    assert np.abs(full - np.asarray(jp.full_solution(jnp.asarray(u)))).max() <= 1e-12


@pytest.mark.parametrize(
    "coarse", ["amg", "amg_petsc", "cg", "cg_with_chebyshev", "cg_with_amg", "direct"]
)
def test_hmg_global_with_each_coarse_type_matches_jax(coarse):
    jres, _, _ = japi.run(params(JParams, "HMG-global", 2, 2, coarse))
    tres, _, _ = tapi.run(params(TParams, "HMG-global", 2, 2, coarse), "cpu")
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert tres.true_residual <= tres.guard_threshold
    assert rel(tres.x, jres.x) <= 1e-8
    kind = type(tres.mg.coarse_solve).__name__
    assert kind == ("CGCoarseSolver" if coarse.startswith("cg") else "DirectCoarseSolver")


@pytest.mark.parametrize("dim, r", [(2, 3), (3, 2)])
def test_cg_with_chebyshev_interval_matches_jax(dim, r):
    from dealii_multigrid_tpu.solvers import coarse as jcoarse

    from test_torch_2d_solve import INTERVAL_BOUND, interval_gaps

    jl, tl = levels(dim, r, 2)
    solvers = [
        C.make_coarse_solver("cg_with_chebyshev", lv.op, lv.dofh, lv.hanging,
                             inv_diag=lv.inv_diag, mg_data=params(P, "HMG-global", r, 2).mg_data,
                             dtype=dt)
        for C, lv, P, dt in ((jcoarse, jl, JParams, jnp.float64),
                             (tcoarse, tl, TParams, torch.float64))
    ]
    gaps = interval_gaps([solvers[1].preconditioner], [solvers[0].preconditioner])
    assert gaps[0] <= INTERVAL_BOUND[torch.float64], gaps


def test_unknown_coarse_type_raises():
    with pytest.raises(ValueError, match="unknown coarse solver type"):
        tapi.run(params(TParams, "HMG-global", 2, 2, "ilu"), "cpu")


@pytest.mark.parametrize("kind", ["cg", "cg_with_chebyshev", "cg_with_amg", "amg_petsc"])
def test_gather_engine_coarse_solver_solves(kind, monkeypatch):
    """make_coarse_solver on the gather-engine operator: each kind inverts
    the operator to its tolerance (the algebraic ones as CG preconditioner
    or, alone, as a contraction)."""
    monkeypatch.setattr(tcoarse, "DIRECT_SOLVER_MAX_DOFS", 100)
    lv = tapi.build_level(TG.create("quadrant", 3, 2), 2, CPU, torch.float64)
    prm = params(TParams, "AMG", 2, 2)
    prm.mg_data.coarse_solver.reltol = 1e-10
    solver = tcoarse.make_coarse_solver(
        kind, lv.op, lv.dofh, lv.hanging, inv_diag=lv.inv_diag,
        mg_data=prm.mg_data, dtype=torch.float64,
    )
    b = lv.op.vmult(torch.as_tensor(np.random.default_rng(5).standard_normal(lv.op.n_dofs)))
    x = solver(b)
    res = float(torch.linalg.norm(b - lv.op.vmult(x)) / torch.linalg.norm(b))
    if kind == "amg_petsc":
        assert isinstance(solver, AMGPreconditioner) and res < 0.5
    else:
        assert res <= 1e-9


def test_slotted_solver_reads_zero_on_dummy_slots():
    class Twice:
        def vmult(self, b):
            return 2.0 * b

    to_idx = torch.tensor([2, 0])
    from_idx = torch.tensor([1, 2, 0, 2])     # 2 = the sentinel n_dofs
    s = tcoarse.SlottedSolver(Twice(), to_idx, from_idx)
    out = s(torch.tensor([1.0, 5.0, 3.0, 7.0]))
    assert out.tolist() == [2.0, 0.0, 6.0, 0.0]
