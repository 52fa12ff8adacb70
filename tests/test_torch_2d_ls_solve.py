"""The port's 2D local smoothing matches the JAX package (CPU).

The port's own Chebyshev intervals on the gather-engine local-smoothing
levels equal the JAX package's (1e-9 relative in float64, 1e-7 in float32:
both start their estimates from ``jax.random.normal(PRNGKey(42))``); one
local-smoothing V-cycle equals the JAX package's to 1e-10 relative, with
the port's own intervals and with the JAX smoothers' intervals copied in;
r=4 p=2 HMG-local and HPMG-local solves take the JAX run's iteration
count with x within the solve's tolerance; mixed (double outer CG over
float levels) takes the double solve's count, in every 2D multigrid type.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.mesh.dof import distribute_dofs as jdofs
from dealii_multigrid_tpu.solvers import local_smoothing as JLS
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.mesh.dof import distribute_dofs as tdofs
from dealii_multigrid_tpu_torch.solvers import local_smoothing as TLS
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams

from test_torch_2d_solve import INTERVAL_BOUND, copy_intervals, interval_gaps, params, rel


def ls_pair(dtype=torch.float64):
    """(JAX, port) 2D local-smoothing hierarchies at quadrant r=4 p=2."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    jmg = JLS.build_local_smoothing_mg(
        jdofs(JG.create("quadrant", 2, 4), 2), params(JParams, "HMG-local").mg_data, dtype=jdt,
    )
    active = tdofs(TG.create("quadrant", 2, 4), 2)
    tmg = TLS.build_local_smoothing_mg(
        active, params(TParams, "HMG-local").mg_data, torch.device("cpu"), dtype
    )
    return jmg, tmg, active


def ls_cycle_gap(jmg, tmg, active) -> float:
    r = np.random.default_rng(9).standard_normal(active.n_dofs)
    jx = jax.jit(lambda m, v: m.vmult(v))(jmg, jnp.asarray(r))
    return rel(tmg.vmult(torch.as_tensor(r)), jx)


def test_ls_cycle_matches_jax():
    jmg, tmg, active = ls_pair()
    assert len(tmg.levels) == len(jmg.levels) == 5
    tmg = dataclasses.replace(tmg, smoothers=copy_intervals(tmg.smoothers, jmg.smoothers))
    assert ls_cycle_gap(jmg, tmg, active) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_ls_own_intervals_match_jax(dtype):
    jmg, tmg, _ = ls_pair(dtype)
    gaps = interval_gaps(tmg.smoothers, jmg.smoothers)
    assert len(gaps) == 4 and max(gaps) <= INTERVAL_BOUND[dtype], gaps


def test_ls_cycle_of_the_ports_own_hierarchy_matches_jax():
    assert ls_cycle_gap(*ls_pair()) <= 1e-10


@pytest.mark.parametrize("mg_type", ["HMG-local", "HPMG-local"])
def test_2d_ls_solve_matches_jax(mg_type):
    jres, jprob, _ = japi.run(params(JParams, mg_type))
    tres, tprob, levels = tapi.run(params(TParams, mg_type), "cpu")
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert tres.n_levels == jres.n_levels and tres.n_dofs == jres.n_dofs
    assert tres.true_residual <= tres.guard_threshold
    assert rel(tres.x, jres.x) <= 1e-4                           # the solve's tolerance
    assert (tres.mg is None) == (mg_type == "HMG-local") and tres.ls_mg is not None
    # the LS levels run at the fine degree (HMG-local) or at degree 1
    assert tres.ls_mg.levels[-1].elem.shape[0] == (9 if mg_type == "HMG-local" else 4)


@pytest.mark.parametrize("mg_type", ["HMG-global", "PMG", "HPMG", "HMG-local", "HPMG-local"])
def test_2d_mixed_matches_double(mg_type):
    double, _, _ = tapi.run(params(TParams, mg_type, r=3), "cpu")
    mixed, _, levels = tapi.run(params(TParams, mg_type, r=3, number="mixed", mg_number="float"), "cpu")
    assert mixed.converged and mixed.n_iterations == double.n_iterations
    assert mixed.x.dtype == torch.float64
    assert rel(mixed.x, double.x) <= 1e-5
    lsmg = mixed.ls_mg
    level_dtype = (lsmg.levels[-1].keep if lsmg is not None else mixed.mg.operators[-1].scale).dtype
    assert level_dtype == torch.float32
