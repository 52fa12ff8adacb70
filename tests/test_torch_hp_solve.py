"""The port's PMG and HPMG solves match the JAX package (CPU, float64).

The level plan (mesh and degree per level) equals the JAX plan; the solves
go through the p-transfers on the fine mesh and the p -> h junction below
them.  Iteration counts must equal the JAX run's and the solutions agree to
1e-8 relative; the Gaussian problem's L2 error, computed on the host from
the cell DoFs and the hanging constraints, equals JAX's to 1e-10 relative.
"""

import numpy as np
import pytest

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence as jseq
from dealii_multigrid_tpu.models import poisson as JP
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence as tseq
from dealii_multigrid_tpu_torch.models import poisson as TP
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams


def params(cls, r, p, number="double", mg_number=None, sim="Constant", mg_type="HMG-global"):
    prm = cls()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.number_type = number
    prm.mg_number_type = mg_number or number
    prm.mg_data.coarse_solver.type = "amg"
    prm.mg_data.smoother.degree = 3
    prm.mg_data.n_repetitions = 1
    prm.simulation_type = sim
    return prm


@pytest.mark.parametrize("r", [3, 4])
@pytest.mark.parametrize("mg_type", ["HMG-global", "PMG", "HPMG"])
def test_level_plan_matches_jax(mg_type, r):
    jplan = japi.gc_level_plan(mg_type, jseq(JG.create("quadrant", 3, r)), 4)
    tplan = tapi.gc_level_plan(mg_type, tseq(TG.create("quadrant", 3, r)), 4)
    assert [(m.n_cells, d) for m, d in tplan] == [(m.n_cells, d) for m, d in jplan]
    assert tplan[-1][1] == 4


def solve_both(mg_type, r, p, sim="Constant"):
    jres, jprob, _ = japi.solve_with_global_coarsening_hybrid(
        params(JParams, r, p, sim=sim, mg_type=mg_type), JG.create("quadrant", 3, r)
    )
    tres, tprob, levels = tapi.run(params(TParams, r, p, sim=sim, mg_type=mg_type), "cpu")
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert tres.true_residual <= tres.guard_threshold
    jx, tx = np.asarray(jres.x), tres.x.numpy()
    assert tx.shape == (levels[-1].dofh.n_dofs,)
    assert np.abs(tx - jx).max() <= 1e-8 * np.abs(jx).max()
    return (jres, jprob), (tres, tprob, levels)


@pytest.mark.parametrize("mg_type,r,p", [
    ("PMG", 3, 2), ("PMG", 3, 4), ("HPMG", 3, 2), ("HPMG", 3, 4),
])
def test_pmg_hpmg_solve_matches_jax(mg_type, r, p):
    _, (tres, _, levels) = solve_both(mg_type, r, p)
    degrees = [lv.degree for lv in levels]
    assert degrees[-1] == p and degrees[0] == 1
    if mg_type == "PMG":
        assert all(lv.mesh is levels[-1].mesh for lv in levels)


def test_hpmg_gaussian_l2_error_matches_jax():
    (jres, jprob), (tres, tprob, _) = solve_both("HPMG", 3, 2, sim="Gaussian")
    jerr = float(JP.l2_error(jprob, jprob.full_solution(jres.x)))
    u = tprob.full_solution(tres.x)
    np.testing.assert_allclose(u, np.asarray(jprob.full_solution(jres.x)), rtol=0, atol=1e-8 * np.abs(u).max())
    terr = TP.l2_error(tprob, u)
    assert abs(terr - jerr) <= 1e-10 * jerr
    assert terr > 0
