"""The PyTorch port's Chebyshev smoother and eigenvalue estimate match JAX.

One HMG-global level (quadrant r=4, p=3, float64) is built by the JAX
package; the port applies the same tables (``from_arrays``), the same
inverse diagonal and the same seed-42 start vector.  The CG-Lanczos
eigenvalue estimate and Chebyshev ``vmult`` / ``step`` must agree to 1e-10
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.solvers import chebyshev as JC
from dealii_multigrid_tpu_torch.ops.hybrid import HybridOperator
from dealii_multigrid_tpu_torch.solvers import chebyshev as TC

TOL = 1e-10


def host_tree(v):
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(host_tree(e) for e in v)
    return np.asarray(v)


@pytest.fixture(scope="module")
def lvl():
    jl = japi.build_level_hybrid(JG.create("quadrant", 3, 4), 3, jnp.float64)
    tables = {k: host_tree(getattr(jl.op, k)) for k in HybridOperator.TABLE_KEYS}
    meta = {k: getattr(jl.op, k) for k in HybridOperator.META_KEYS}
    op = HybridOperator.from_arrays(tables, meta, torch.device("cpu"), torch.float64)
    inv_diag = torch.as_tensor(np.array(jl.inv_diag))
    b0 = torch.as_tensor(np.array(jl.eig_b0))
    return jl, op, inv_diag, b0


def test_eigenvalue_estimate_matches_jax(lvl):
    jl, op, inv_diag, b0 = lvl
    want = JC.estimate_eigenvalue_range(
        jl.op, jl.inv_diag, 20, use_op_dot=True, b0=jl.eig_b0
    )
    got = TC.estimate_eigenvalue_range(op, inv_diag, b0, 20, use_op_dot=True)
    assert abs(got[0] - want[0]) <= TOL * abs(want[0])
    assert abs(got[1] - want[1]) <= TOL * abs(want[1])
    # the batched hierarchy entry point is the same estimate per level
    assert TC.estimate_eigenvalue_ranges([op], [inv_diag], [b0], 20, True) == [got]


@pytest.mark.parametrize("degree", [1, 3, 5])
def test_chebyshev_vmult_and_step_match_jax(lvl, degree):
    jl, op, inv_diag, _ = lvl
    lam = 2.19
    jsm = JC.ChebyshevSmoother.create(
        jl.op, jl.inv_diag, degree=degree, smoothing_range=20.0,
        max_eigenvalue=1.2 * lam,
    )
    sm = TC.ChebyshevSmoother.create(
        op, inv_diag, max_eigenvalue=1.2 * lam, degree=degree, smoothing_range=20.0
    )
    rng = np.random.default_rng(3)
    n = jl.dofh.n_dofs
    b = jl.fmt.from_global(rng.normal(size=n))
    x = jl.fmt.from_global(rng.normal(size=n))
    want = np.asarray(jax.jit(jsm.vmult)(jnp.asarray(b)))
    got = sm.vmult(torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    want = np.asarray(jax.jit(jsm.step)(jnp.asarray(x), jnp.asarray(b)))
    got = sm.step(torch.as_tensor(x), torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
