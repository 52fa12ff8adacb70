"""The port's mixed and df32 number types match the JAX package (CPU).

Both keep float32 levels.  mixed runs the outer CG on float64 vectors around
the float32 fine operator (api.MixedPrecisionOperator); df32 runs it on
double-single float32 pairs (solvers/twofloat.py).  Each must take the JAX
run's iteration count in the same number type, with x within 1e-5 relative,
and pass the true-residual guard, whose floor comes from the float32 inner
operator.  After tests/test_twofloat.py: df32 tracks mixed within one
iteration and 1e-5, and its Gaussian L2 error stays at mixed's level.
"""

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.models import poisson as TP
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams

from test_torch_hp_solve import params


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("number", ["mixed", "df32"])
@pytest.mark.parametrize("mg_type", ["HMG-global", "HPMG"])
def test_mixed_and_df32_match_jax(mg_type, number):
    jres, _, _ = japi.solve_with_global_coarsening_hybrid(
        params(JParams, 3, 2, number, "float", mg_type=mg_type), JG.create("quadrant", 3, 3)
    )
    tres, _, levels = tapi.run(params(TParams, 3, 2, number, "float", mg_type=mg_type), "cpu")
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert levels[-1].op.dtype == torch.float32
    want = torch.float64 if number == "mixed" else torch.float32
    assert tres.x.dtype == want and tres.rhs_used.dtype == want
    assert rel(tres.x, jres.x) <= 1e-5
    # the guard passed, with the float32 operator's floor under it
    fine = levels[-1]
    b = tres.rhs_used.double()
    norm_b = float(torch.sqrt(torch.sum(b * fine.op.owner.double() * b)))
    assert tres.true_residual <= tres.guard_threshold
    assert tres.guard_threshold >= 1e4 * torch.finfo(torch.float32).eps * norm_b * (1 - 1e-6)


def test_mixed_operator_applies_float32_and_dots_in_float64():
    prm = params(TParams, 2, 2, "double", "float")
    _, _, levels = tapi.run(prm, "cpu")
    op = levels[-1].op
    mop = tapi.MixedPrecisionOperator(op)
    x = torch.as_tensor(
        levels[-1].fmt.from_global(np.random.default_rng(3).standard_normal(levels[-1].dofh.n_dofs))
    )
    y = mop.vmult(x)
    assert mop.dtype == torch.float64 and y.dtype == torch.float64
    assert torch.equal(y, op.vmult(x.float()).double())
    assert mop.dot(x, x).dtype == torch.float64
    assert float(mop.dot(x, x)) == float(torch.sum(x * op.owner.double() * x))


def test_df32_tracks_mixed():
    res = {}
    for number in ("mixed", "df32"):
        prm = params(TParams, 3, 2, number, "float")
        prm.mg_data.cg_normal.reltol = 1e-8
        res[number], _, _ = tapi.run(prm, "cpu")
    assert res["mixed"].converged and res["df32"].converged
    assert abs(res["mixed"].n_iterations - res["df32"].n_iterations) <= 1
    assert rel(res["df32"].x, res["mixed"].x) <= 1e-5


def test_df32_gaussian_l2_error_at_mixed_level():
    errs = {}
    for number in ("mixed", "df32"):
        prm = params(TParams, 4, 2, number, "float", sim="Gaussian")
        prm.mg_data.cg_normal.reltol = 1e-8
        res, prob, _ = tapi.run(prm, "cpu")
        errs[number] = TP.l2_error(prob, prob.full_solution(res.x))
    assert errs["df32"] < 1.3 * errs["mixed"], errs
