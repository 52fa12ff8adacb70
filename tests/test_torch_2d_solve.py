"""The port's 2D global-coarsening multigrid matches the JAX package (CPU).

2D runs on the gather engine in both packages.  Both start the eigenvalue
estimates of its levels from ``jax.random.normal(PRNGKey(42))`` (the port
through ``utils.threefry``), so the port's own Chebyshev intervals equal
the JAX package's: to 1e-9 relative on float64 levels and to 1e-7 on
float32 levels (measured: at most 1.4e-8, the float32 CG-Lanczos summing
in another order).  One V-cycle of a 2D HMG-global hierarchy equals the
JAX package's to 1e-10 relative, with the port's own intervals and with
the JAX smoothers' intervals copied in.  Whole r=4 p=2
solves of HMG-global, PMG and HPMG take the JAX run's iteration count, and
x agrees to the solve's tolerance; df32 raises as in the JAX package; the
instrumented solve returns all nine phases, and its per-level sums add up
to them.
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
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams
from dealii_multigrid_tpu_torch.utils.phases import PHASES, VCYCLE_KEYS

CPU = torch.device("cpu")
# relative gap of the Chebyshev centre and half-width, port against JAX
INTERVAL_BOUND = {torch.float64: 1e-9, torch.float32: 1e-7}


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


def interval_gaps(smoothers, jsmoothers) -> list[float]:
    """Per smoothed level, the larger relative gap of theta and delta."""
    return [
        max(abs(s.theta - float(j.theta)) / abs(float(j.theta)),
            abs(s.delta - float(j.delta)) / abs(float(j.delta)))
        for s, j in zip(smoothers, jsmoothers) if s is not None
    ]


def copy_intervals(smoothers, jsmoothers) -> tuple:
    """The port's smoothers with the JAX smoothers' Chebyshev intervals."""
    return tuple(
        None if s is None else dataclasses.replace(s, theta=j.theta, delta=j.delta)
        for s, j in zip(smoothers, jsmoothers)
    )


def gc_pair(dtype=torch.float64):
    """(JAX, port) 2D HMG-global hierarchies at quadrant r=4 p=2, each
    package's own build."""
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    jl = [japi.build_level(m, 2, jdt) for m in jcoarsen(JG.create("quadrant", 2, 4))]
    tl = [tapi.build_level(m, 2, CPU, dtype) for m in tcoarsen(TG.create("quadrant", 2, 4))]
    jmg, _ = japi.build_gc_preconditioner(jl, params(JParams, "HMG-global").mg_data, jdt, jdt)
    tmg = tapi.build_gc_preconditioner(tl, params(TParams, "HMG-global").mg_data)
    return jmg, tmg, tl


def one_v_cycle_gap(jmg, tmg, tl) -> float:
    b = np.random.default_rng(5).standard_normal(tl[-1].dofh.n_dofs)
    b[tl[-1].op.constrained.numpy()] = 0.0
    jx = jax.jit(lambda m, v: m.vmult(v))(jmg, jnp.asarray(b))
    return rel(tmg.vmult(torch.as_tensor(b)), jx)


def test_gc_v_cycle_matches_jax():
    jmg, tmg, tl = gc_pair()
    assert tmg.n_levels == len(jmg.operators) == 5
    # the estimates agree (the same start vectors) ...
    assert max(interval_gaps(tmg.smoothers, jmg.smoothers)) <= INTERVAL_BOUND[torch.float64]
    # ... and with the JAX intervals one V-cycle agrees to roundoff
    tmg = dataclasses.replace(tmg, smoothers=copy_intervals(tmg.smoothers, jmg.smoothers))
    assert one_v_cycle_gap(jmg, tmg, tl) <= 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_gc_own_intervals_match_jax(dtype):
    jmg, tmg, _ = gc_pair(dtype)
    gaps = interval_gaps(tmg.smoothers, jmg.smoothers)
    assert len(gaps) == 4 and max(gaps) <= INTERVAL_BOUND[dtype], gaps


def test_gc_v_cycle_of_the_ports_own_hierarchy_matches_jax():
    """No interval is copied: the port's set-up alone gives JAX's V-cycle."""
    jmg, tmg, tl = gc_pair()
    assert one_v_cycle_gap(jmg, tmg, tl) <= 1e-10


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
    phases = res.phases
    assert set(phases) == set(VCYCLE_KEYS) and len(phases) == 9
    for ph in ("pre", "residuum", "res", "cs", "pro", "post", "to_mg", "to_global"):
        assert phases[ph] > 0.0, ph
    assert (phases["edge_pro"] > 0.0) == (mg_type == "HMG-local")
    # the per-level sums of the same solve, every level above the coarsest
    n_levels = len((res.mg or res.ls_mg).smoothers)
    for ph in PHASES:
        per = res.phases_per_level[ph]
        assert len(per) == (1 if ph == "cs" else n_levels - 1)
        assert sum(per) == pytest.approx(phases[ph], rel=1e-12, abs=1e-15)
    # the in-solve phases are parts of the instrumented iteration
    assert sum(res.phases.values()) <= res.phase_iteration_time
