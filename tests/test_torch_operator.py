"""The PyTorch port's HybridOperator applies like the JAX one (CPU, float64).

The port operator is built with ``HybridOperator.from_arrays`` from the JAX
operator's own data leaves (as NumPy arrays), so both packages apply
identical tables; vmult, dot, apply_c and apply_ct must agree to 1e-10
relative on consistent slot vectors (every slot of a DoF holds the DoF's
value), on the geometries of tests/test_hybrid.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.ops import hybrid as JH
from dealii_multigrid_tpu_torch.ops.hybrid import HybridOperator

TOL = 1e-10


def host_tree(v):
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(host_tree(e) for e in v)
    return np.asarray(v)


def port_operator(jop, dtype=torch.float64) -> HybridOperator:
    tables = {k: host_tree(getattr(jop, k)) for k in HybridOperator.TABLE_KEYS}
    meta = {k: getattr(jop, k) for k in HybridOperator.META_KEYS}
    return HybridOperator.from_arrays(tables, meta, torch.device("cpu"), dtype)


def build(geo, r, p, K=4):
    m = JG.create(geo, 3, r)
    dofh = JD.distribute_dofs(m, p)
    hang = JD.make_hanging_node_constraints(dofh)
    fmt = JH.build_hybrid_format(dofh, K=K)
    jop = JH.make_hybrid_operator(fmt, hang, dtype=jnp.float64)
    return dofh, fmt, jop, port_operator(jop)


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-300))


GEOMETRIES = [
    ("hypercube", 2, 2),
    ("quadrant", 3, 2),
    ("quadrant", 4, 3),
    ("annulus", 5, 2),   # patch<->singleton cross exchange (use_cross)
    ("circle", 5, 2),
]


@pytest.mark.parametrize("geo,r,p", GEOMETRIES)
def test_vmult_apply_c_apply_ct_match_jax(geo, r, p):
    dofh, fmt, jop, op = build(geo, r, p)
    rng = np.random.default_rng(0)
    u = fmt.from_global(rng.normal(size=dofh.n_dofs))
    for name in ("vmult", "apply_c", "apply_ct"):
        want = jax.jit(getattr(jop, name))(jnp.asarray(u))
        got = getattr(op, name)(torch.as_tensor(u.copy()))
        assert got.dtype == torch.float64
        assert rel_err(got, want) < TOL, name


def test_cross_exchange_level_is_exercised():
    _, _, jop, op = build("annulus", 5, 2)
    assert op.use_cross and jop.use_cross


def test_dot_matches_jax():
    dofh, fmt, jop, op = build("quadrant", 3, 2)
    rng = np.random.default_rng(1)
    u, v = (fmt.from_global(w) for w in rng.normal(size=(2, dofh.n_dofs)))
    want = float(jop.dot(jnp.asarray(u), jnp.asarray(v)))
    got = float(op.dot(torch.as_tensor(u), torch.as_tensor(v)))
    assert abs(got - want) <= TOL * abs(want)


def test_float32_vmult_close_to_float64():
    """The float levels of the main path: same tables in float32."""
    dofh, fmt, jop, op = build("quadrant", 4, 3)
    op32 = port_operator(jop, torch.float32)
    u = fmt.from_global(np.random.default_rng(2).normal(size=dofh.n_dofs))
    r64 = op.vmult(torch.as_tensor(u))
    r32 = op32.vmult(torch.as_tensor(u, dtype=torch.float32))
    assert r32.dtype == torch.float32
    assert rel_err(r32.double(), r64.numpy()) < 1e-5
