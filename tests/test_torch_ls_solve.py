"""The port's HMG-local and HPMG-local solves match the JAX package (CPU).

The whole local-smoothing path through ``tapi.run(..., "cpu")`` against
``japi.run``: the active-mesh fine level and outer CG, the LS hierarchy
(HMG-local) or the p-levels above the degree-1 LS hierarchy (HPMG-local).
In double: equal iteration counts and x within 1e-8 relative; in mixed and
df32 over float levels: equal counts and x within 1e-5; the Gaussian
problem's L2 error equal to JAX's within 1e-10 relative.
"""

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.models import poisson as JP
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.models import poisson as TP
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams

from test_torch_hp_solve import params


def solve_both(mg_type, r, p, number="double", mg_number=None, sim="Constant"):
    jres, jprob, _ = japi.run(params(JParams, r, p, number, mg_number, sim, mg_type))
    tres, tprob, levels = tapi.run(params(TParams, r, p, number, mg_number, sim, mg_type), "cpu")
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert tres.true_residual <= tres.guard_threshold
    assert tres.n_levels == jres.n_levels
    assert len(levels) == 1 and tres.x.shape == (levels[0].dofh.n_dofs,)
    return (jres, jprob), (tres, tprob, levels)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mg_type", ["HMG-local", "HPMG-local"])
@pytest.mark.parametrize("r,p", [(3, 2), (4, 2), (3, 4)])
def test_ls_solve_double_matches_jax(mg_type, r, p):
    (jres, _), (tres, _, _) = solve_both(mg_type, r, p)
    jx, tx = np.asarray(jres.x), tres.x.numpy()
    assert np.abs(tx - jx).max() <= 1e-8 * np.abs(jx).max()
    lsmg = tres.ls_mg
    assert (tres.mg is None) == (mg_type == "HMG-local")
    # the LS levels run at the fine degree (HMG-local) or at degree 1
    # (HPMG-local, below the p-levels 4 -> 2 -> 1 or 2 -> 1)
    assert lsmg.levels[-1].fmt.dofh.degree == (p if mg_type == "HMG-local" else 1)
    assert len(lsmg.levels) == r + 1


@pytest.mark.parametrize("number", ["mixed", "df32"])
@pytest.mark.parametrize("mg_type", ["HMG-local", "HPMG-local"])
def test_ls_solve_mixed_and_df32_match_jax(mg_type, number):
    (jres, _), (tres, _, _) = solve_both(mg_type, 3, 2, number, "float")
    assert rel(tres.x, jres.x) <= 1e-5
    assert tres.x.dtype == (torch.float64 if number == "mixed" else torch.float32)


@pytest.mark.parametrize("mg_type", ["HMG-local", "HPMG-local"])
def test_ls_gaussian_l2_error_matches_jax(mg_type):
    (jres, jprob), (tres, tprob, _) = solve_both(mg_type, 3, 2, sim="Gaussian")
    jerr = float(JP.l2_error(jprob, jprob.full_solution(jres.x)))
    terr = TP.l2_error(tprob, tprob.full_solution(tres.x))
    assert terr > 0 and abs(terr - jerr) <= 1e-10 * jerr
