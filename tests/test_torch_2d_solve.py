"""The port's 2D global-coarsening multigrid matches the JAX package (CPU).

2D runs on the gather engine in both packages.  One V-cycle of a 2D
HMG-global hierarchy equals the JAX package's to 1e-10 relative once the
JAX smoothers' Chebyshev intervals are copied in (the two packages draw
their eigenvalue start vectors from different generators).  Whole r=4 p=2
solves of HMG-global, PMG and HPMG take the JAX run's iteration count, and
x agrees to the solve's tolerance; df32 raises as in the JAX package; the
phase profilers, in loops and inside a solve, return all nine phases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence as jcoarsen
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import generators as TG
from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence as tcoarsen
from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams
from dealii_multigrid_tpu_torch.utils.phases import KEYS, profile_preconditioner

CPU = torch.device("cpu")


def params(cls, mg_type, r=4, p=2, number="double", mg_number=None):
    prm = cls()
    prm.type = mg_type
    prm.dim = 2
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.number_type = number
    prm.mg_number_type = mg_number or number
    prm.mg_data.coarse_solver.type = "amg"
    prm.mg_data.smoother.degree = 3
    prm.mg_data.n_repetitions = 1
    return prm


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def copy_intervals(smoothers, jsmoothers) -> tuple:
    """The port's smoothers with the JAX smoothers' Chebyshev intervals."""
    return tuple(
        None if s is None else dataclasses.replace(s, theta=j.theta, delta=j.delta)
        for s, j in zip(smoothers, jsmoothers)
    )


def test_gc_v_cycle_matches_jax():
    mg_data = params(TParams, "HMG-global").mg_data
    jl = [japi.build_level(m, 2, jnp.float64) for m in jcoarsen(JG.create("quadrant", 2, 4))]
    tl = [tapi.build_level(m, 2, CPU, torch.float64) for m in tcoarsen(TG.create("quadrant", 2, 4))]
    jmg, _ = japi.build_gc_preconditioner(jl, params(JParams, "HMG-global").mg_data,
                                          jnp.float64, jnp.float64)
    tmg = tapi.build_gc_preconditioner(tl, mg_data)
    assert tmg.n_levels == len(jmg.operators) == 5
    # the estimates differ a little (different start vectors) ...
    for s, j in zip(tmg.smoothers[1:], jmg.smoothers[1:]):
        assert abs(s.theta - j.theta) <= 0.05 * j.theta
    # ... and with the JAX intervals one V-cycle agrees to roundoff
    tmg = dataclasses.replace(tmg, smoothers=copy_intervals(tmg.smoothers, jmg.smoothers))
    b = np.random.default_rng(5).standard_normal(tl[-1].dofh.n_dofs)
    b[tl[-1].op.constrained.numpy()] = 0.0
    jx = jax.jit(lambda m, v: m.vmult(v))(jmg, jnp.asarray(b))
    assert rel(tmg.vmult(torch.as_tensor(b)), jx) <= 1e-10


@pytest.mark.parametrize("mg_type", ["HMG-global", "PMG", "HPMG"])
def test_2d_gc_solve_matches_jax(mg_type):
    jres, jprob, _ = japi.run(params(JParams, mg_type))
    tres, tprob, levels = tapi.run(params(TParams, mg_type), "cpu")
    assert tres.converged and jres.converged
    assert tres.n_iterations == jres.n_iterations
    assert tres.solve_iterations == [tres.n_iterations] * 2
    assert tres.n_levels == jres.n_levels and tres.n_dofs == jres.n_dofs
    assert tres.true_residual <= tres.guard_threshold
    assert rel(tres.x, jres.x) <= 1e-4                           # the solve's tolerance
    assert rel(tprob.rhs, jprob.rhs) <= 1e-12
    assert levels[-1].dofh.dim == 2 and tres.mg is not None


def test_2d_df32_raises_like_jax():
    for mg_type in ("HMG-global", "HMG-local"):
        with pytest.raises(ValueError, match="df32"):
            tapi.run(params(TParams, mg_type, r=2, number="df32"), "cpu")
    with pytest.raises(ValueError, match="df32"):
        japi.run(params(JParams, "HMG-global", r=2, number="df32"))


@pytest.mark.parametrize("mg_type", ["HMG-global", "HMG-local"])
def test_2d_phase_profilers_return_nine_keys(mg_type):
    prm = params(TParams, mg_type, r=3)
    prm.profile_phases = True
    res, _, _ = tapi.run(prm, "cpu")
    precond = res.ls_mg if res.mg is None else PreconditionMG(res.mg, torch.float64)
    looped = profile_preconditioner(precond, res.rhs_used, n_loop=2)
    for phases in (looped, res.phases):
        assert set(phases) == set(KEYS) and len(phases) == 9
        for ph in ("pre", "residuum", "res", "cs", "pro", "post", "to_mg", "to_global"):
            assert phases[ph] > 0.0, ph
        assert (phases["edge_pro"] > 0.0) == (mg_type == "HMG-local")
    # the in-solve phases are parts of the instrumented iteration
    assert sum(res.phases.values()) <= res.phase_iteration_time
