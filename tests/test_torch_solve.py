"""The PyTorch port's HMG-global solve matches the JAX package (CPU, float64).

The whole slice: mesh, DoFs, hybrid layout, operator, transfers, Chebyshev
smoothers with their eigenvalue estimates, the dense coarse solve, the
V-cycle and the outer CG, each package with its own host setup code.  The CG
iteration count must equal the JAX run's and the solutions must agree to
1e-8 relative.
"""

import jax
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams


def params(cls, r, p, number="double", sim="Constant", mg_type="HMG-global"):
    prm = cls()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.number_type = number
    prm.mg_number_type = number
    prm.mg_data.coarse_solver.type = "amg"
    prm.mg_data.smoother.degree = 3
    prm.mg_data.n_repetitions = 1
    prm.simulation_type = sim
    return prm


@pytest.mark.parametrize(
    "r,p,sim", [(3, 2, "Constant"), (4, 4, "Constant"), (3, 2, "Gaussian")]
)
def test_hmg_global_solve_matches_jax(r, p, sim):
    jres, jprob, _ = japi.solve_with_global_coarsening_hybrid(
        params(JParams, r, p, sim=sim), JG.create("quadrant", 3, r)
    )
    tres, tprob, levels = tapi.run(params(TParams, r, p, sim=sim), "cpu")
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert tres.true_residual <= tres.guard_threshold
    jx = np.asarray(jres.x)
    tx = tres.x.numpy()
    assert tx.shape == (levels[-1].dofh.n_dofs,)
    assert np.abs(tx - jx).max() <= 1e-8 * np.abs(jx).max()
    assert np.abs(tprob.rhs.numpy() - np.asarray(jprob.rhs)).max() <= 1e-10 * np.abs(
        np.asarray(jprob.rhs)
    ).max()


def test_float_levels_solve_converges_like_double():
    """The main path's number type: float levels and float outer CG."""
    res32, _, _ = tapi.run(params(TParams, 4, 4, "float"), "cpu")
    res64, _, _ = tapi.run(params(TParams, 4, 4, "double"), "cpu")
    assert res32.x.dtype == torch.float32
    assert res32.converged and res32.n_iterations == res64.n_iterations
    rel = (res32.x.double() - res64.x).abs().max() / res64.x.abs().max()
    assert float(rel) < 1e-4


def test_float_levels_under_double_outer_cg():
    prm = params(TParams, 3, 2, "double")
    prm.mg_number_type = "float"
    res, _, levels = tapi.run(prm, "cpu")
    assert res.converged and res.x.dtype == torch.float64
    assert levels[-1].op.dtype == torch.float32


@pytest.mark.parametrize(
    "field,value,item",
    [
        ("type", "PMG", "item 7"),
        ("type", "HMG-local", "item 8"),
        ("type", "AMG", "item 10"),
        ("number_type", "mixed", "item 6"),
        ("number_type", "df32", "item 6"),
    ],
)
def test_unported_configurations_name_their_roadmap_item(field, value, item):
    prm = params(TParams, 2, 2)
    setattr(prm, field, value)
    with pytest.raises(NotImplementedError, match=item):
        tapi.run(prm, "cpu")


def test_unported_coarse_type_raises():
    prm = params(TParams, 2, 2)
    prm.mg_data.coarse_solver.type = "cg_with_chebyshev"
    with pytest.raises(NotImplementedError, match="item 10"):
        tapi.run(prm, "cpu")


def test_large_coarse_level_needs_amg():
    from dealii_multigrid_tpu_torch.mesh import dof as TD
    from dealii_multigrid_tpu_torch.solvers.coarse import make_algebraic_solver

    dofh = TD.distribute_dofs(TG.create("quadrant", 3, 3), 4)  # 9295 DoFs > 8000
    hang = TD.make_hanging_node_constraints(dofh)
    idx = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="item 10"):
        make_algebraic_solver(dofh, hang, idx, idx, torch.float64)


def test_parameter_study_runs_fixed_iterations():
    """DoParameterStudy: exactly cg_parameter_study.maxiter iterations, no
    convergence test (the reference's fixed-work mode)."""
    prm = params(TParams, 2, 2)
    prm.mg_data.do_parameter_study = True
    prm.mg_data.cg_parameter_study.maxiter = 4
    res, _, _ = tapi.run(prm, "cpu")
    assert res.solve_iterations == [4, 4]
