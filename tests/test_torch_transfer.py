"""The PyTorch port's HybridTransfer prolongs and restricts like the JAX one.

Both transfers apply identical tables: the port's are built with
``HybridTransfer.from_arrays`` from the JAX transfer's data leaves (as NumPy
arrays).  prolong and restrict must agree to 1e-10 relative in float64 on
consistent vectors, for an h-transfer (same patch size on both levels),
p-transfers 2 -> 1 and 4 -> 2 on one mesh, and an h-transfer whose coarse
level uses half the patch size (the octant-identity and
whole-coarse-patch-parent buckets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence
from dealii_multigrid_tpu.ops import hybrid as JH, hybrid_transfer as JHT
from dealii_multigrid_tpu_torch.ops.hybrid import HybridOperator
from dealii_multigrid_tpu_torch.ops.hybrid_transfer import HybridTransfer

TOL = 1e-10


def host_tree(v):
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(host_tree(e) for e in v)
    return np.asarray(v)


def port_operator(jop) -> HybridOperator:
    tables = {k: host_tree(getattr(jop, k)) for k in HybridOperator.TABLE_KEYS}
    meta = {k: getattr(jop, k) for k in HybridOperator.META_KEYS}
    return HybridOperator.from_arrays(tables, meta, torch.device("cpu"), torch.float64)


def port_transfer(jt, fop, cop) -> HybridTransfer:
    tables = {k: host_tree(getattr(jt, k)) for k in HybridTransfer.TABLE_KEYS}
    tables["id_oct"] = tuple(e[:2] for e in tables["id_oct"])  # no TPU lane routing
    meta = {k: getattr(jt, k) for k in HybridTransfer.META_KEYS}
    return HybridTransfer.from_arrays(
        tables, meta, fop, cop, torch.device("cpu"), torch.float64
    )


def level(mesh, p, K):
    dofh = JD.distribute_dofs(mesh, p)
    hang = JD.make_hanging_node_constraints(dofh)
    fmt = JH.build_hybrid_format(dofh, K=K)
    return dofh, fmt, JH.make_hybrid_operator(fmt, hang, dtype=jnp.float64)


def case(kind):
    if kind == "h":
        seq = geometric_coarsening_sequence(JG.create_quadrant(3, 4))
        return (seq[-1], 2, 4), (seq[-2], 2, 4)
    if kind == "p":
        m = JG.create_quadrant(3, 4)
        return (m, 2, 4), (m, 1, 4)
    if kind == "p42":
        m = JG.create_quadrant(3, 3)
        return (m, 4, 4), (m, 2, 4)
    # one refined octant on a uniform cube, coarse K = fine K / 2
    seq = geometric_coarsening_sequence(JG.create_quadrant_flexible(3, 3, 1))
    return (seq[-1], 2, 4), (seq[-2], 2, 2)


@pytest.mark.parametrize("kind", ["h", "p", "p42", "cross_k"])
def test_prolong_restrict_match_jax(kind):
    (fm, pf, Kf), (cm, pc, Kc) = case(kind)
    fd, ff, fjop = level(fm, pf, Kf)
    cd, cf, cjop = level(cm, pc, Kc)
    jt = JHT.make_hybrid_transfer(ff, cf, fjop, cjop, dtype=jnp.float64)
    tr = port_transfer(jt, port_operator(fjop), port_operator(cjop))
    if kind == "cross_k":
        assert tr.id_oct and tr.patch_buckets
    rng = np.random.default_rng(2)
    uc = cf.from_global(rng.normal(size=cd.n_dofs))
    want = np.asarray(jax.jit(jt.prolong)(jnp.asarray(uc)))
    got = tr.prolong(torch.as_tensor(uc)).numpy()
    assert np.abs(got - want).max() < TOL * max(np.abs(want).max(), 1)
    rf = ff.from_global(rng.normal(size=fd.n_dofs))
    want = np.asarray(jax.jit(jt.restrict)(jnp.asarray(rf)))
    got = tr.restrict(torch.as_tensor(rf)).numpy()
    assert np.abs(got - want).max() < TOL * max(np.abs(want).max(), 1)
