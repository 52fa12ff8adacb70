"""Solves whose coarse or only preconditioner is really AMG, against the JAX
package (CPU, float64): x to 1e-8 relative, equal iteration counts.

The direct-solve size limit ``DIRECT_SOLVER_MAX_DOFS`` is lowered in both
packages for the test's duration, so that the small coarse levels here get
a multi-level AMG hierarchy.  Truncated HPMG: ``MinLevel`` above the finest
mesh level leaves only the fine mesh (p = 1, 2), and the coarse solve works
on the fine mesh at p = 1.
"""

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.solvers import coarse as jcoarse
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.solvers import coarse as tcoarse
from dealii_multigrid_tpu_torch.solvers.amg import AMGPreconditioner
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams


@pytest.fixture
def small_direct_limit(monkeypatch):
    monkeypatch.setattr(jcoarse, "DIRECT_SOLVER_MAX_DOFS", 300)
    monkeypatch.setattr(tcoarse, "DIRECT_SOLVER_MAX_DOFS", 300)


def params(cls, mg_type, r, p, coarse="amg", n_cycles=1, min_level=-1, dim=3,
           number="double"):
    prm = cls()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.dim = dim
    prm.min_level = min_level
    prm.number_type = number
    prm.mg_number_type = "double"
    prm.mg_data.coarse_solver.type = coarse
    prm.mg_data.coarse_solver.n_cycles = n_cycles
    prm.mg_data.smoother.degree = 3
    prm.mg_data.n_repetitions = 1
    return prm


def assert_same_solve(jres, tres):
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert tres.n_levels == jres.n_levels and tres.n_dofs == jres.n_dofs
    assert tres.true_residual <= tres.guard_threshold
    jx = np.asarray(jres.x)
    assert np.abs(tres.x.numpy() - jx).max() <= 1e-8 * np.abs(jx).max()


def amg_of(solver) -> AMGPreconditioner:
    amg = tcoarse.find_amg(solver)
    assert isinstance(amg, AMGPreconditioner) and len(amg.levels) >= 2
    return amg


@pytest.mark.parametrize(
    "coarse,n_cycles", [("amg", 1), ("amg", 2), ("amg_petsc", 2), ("cg_with_amg", 1)]
)
def test_truncated_hpmg_with_amg_coarse_matches_jax(small_direct_limit, coarse, n_cycles):
    args = ("HPMG", 4, 2, coarse, n_cycles, 5)
    jres, _, _ = japi.run(params(JParams, *args))
    tres, _, levels = tapi.run(params(TParams, *args), "cpu")
    assert_same_solve(jres, tres)
    assert [lv.degree for lv in levels] == [1, 2] and levels[0].mesh is levels[1].mesh
    amg = amg_of(tres.mg.coarse_solve)
    assert amg.levels[0].A.shape[0] == levels[0].dofh.n_dofs == 1008
    assert amg.n_cycles == (n_cycles if coarse != "cg_with_amg" else 1)


@pytest.mark.parametrize("mg_type,r,p,dim", [
    ("AMG", 4, 1, 3), ("AMGPETSc", 4, 2, 3), ("AMG", 5, 2, 2), ("AMGPETSc", 5, 2, 2),
])
def test_amg_solver_types_match_jax(small_direct_limit, mg_type, r, p, dim):
    jres, _, _ = japi.run(params(JParams, mg_type, r, p, dim=dim))
    tres, tprob, levels = tapi.run(params(TParams, mg_type, r, p, dim=dim), "cpu")
    assert_same_solve(jres, tres)
    assert tres.n_levels == 1 and tres.mg is None and tres.ls_mg is None
    amg = amg_of(tres.amg)
    assert amg.levels[0].omega == (0.9 if mg_type == "AMGPETSc" else 2.0 / 3.0)
    assert tres.x.shape == (levels[0].dofh.n_dofs,) and tprob.dofh is levels[0].dofh


def test_amg_mixed_number_type_runs_in_float64(small_direct_limit):
    tres, _, levels = tapi.run(params(TParams, "AMG", 4, 1, number="mixed"), "cpu")
    assert tres.converged and tres.x.dtype == torch.float64
    assert levels[0].op.dtype == torch.float64


def test_amg_below_the_direct_limit_is_a_dense_solve():
    tres, _, _ = tapi.run(params(TParams, "AMG", 3, 2), "cpu")
    assert type(tres.amg).__name__ == "DirectCoarseSolver"
    assert tres.n_iterations == 1


def test_local_smoothing_with_amg_coarse_matches_jax(small_direct_limit):
    """MinLevel 2 leaves the LS hierarchy's coarsest level at 4,913 DoFs."""
    args = ("HMG-local", 3, 4, "amg", 1, 2)
    jres, _, _ = japi.run(params(JParams, *args))
    tres, _, _ = tapi.run(params(TParams, *args), "cpu")
    assert_same_solve(jres, tres)
    assert amg_of(tres.ls_mg.coarse_solve).levels[0].A.shape[0] == 4913


def test_df32_with_amg_raises():
    with pytest.raises(ValueError, match="df32"):
        tapi.run(params(TParams, "AMG", 2, 2, number="df32"), "cpu")


def test_2d_multigrid_names_its_roadmap_item():
    """2D multigrid (ROADMAP item 11) solves on the gather engine now; what
    still raises in 2D names its item (13, sharding)."""
    res, _, _ = tapi.run(params(TParams, "HMG-global", 3, 2, dim=2), "cpu")
    assert res.converged and res.mg is not None
    prm = params(TParams, "HMG-global", 3, 2, dim=2)
    prm.n_shards = 2
    with pytest.raises(NotImplementedError, match="item 13"):
        tapi.run(prm, "cpu")
