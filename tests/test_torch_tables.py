"""Host tables of the PyTorch port equal the JAX package's exactly.

Both packages build the hybrid layout, the operator tables and the transfer
tables from the same meshes; integers must match exactly and floats must be
bit-equal (the JAX tables are built in float64).  Covered hierarchies:
quadrant r=3 p=2, quadrant r=4 p=4 and annulus r=5 p=2 (default K=8, the
solve path's layouts).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence as j_gcs
from dealii_multigrid_tpu.ops import hybrid as JH, hybrid_transfer as JHT
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence as t_gcs
from dealii_multigrid_tpu_torch.ops import hybrid_format as TF
from dealii_multigrid_tpu_torch.ops.hybrid import HybridOperator
from dealii_multigrid_tpu_torch.ops.hybrid_transfer import HybridTransfer, hybrid_transfer_tables

CASES = [("quadrant", 3, 2), ("quadrant", 4, 4), ("annulus", 5, 2)]
FORMAT_FIELDS = (
    "K", "S", "patch_level", "patch_block", "patch_cells", "patch_dof", "nbr",
    "single_cells", "slot_dof", "rep_slot", "owner", "nbr_s",
    "use_singleton_sweeps", "irr_slots", "irr_out_slots", "irr_out_group",
    "cross_faces", "use_cross",
)


def host_tree(v):
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(host_tree(e) for e in v)
    return np.asarray(v)


def assert_tree_equal(a, b, path):
    if a is None or b is None:
        assert a is None and b is None, path
        return
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert isinstance(a, tuple) and isinstance(b, tuple), path
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        # float tables: bit-equal values (float32 masks widen exactly)
        assert np.array_equal(a.astype(np.float64), b.astype(np.float64)), path
    else:
        assert np.array_equal(a, b), path


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-r{c[1]}-p{c[2]}")
def hierarchy(request):
    """Both packages' level builds for one hierarchy (coarsest first)."""
    geo, r, p = request.param
    jl, tl = [], []
    for jm, tm in zip(j_gcs(JG.create(geo, 3, r)), t_gcs(TG.create(geo, 3, r))):
        jd = JD.distribute_dofs(jm, p)
        jh = JD.make_hanging_node_constraints(jd)
        jf = JH.build_hybrid_format(jd)
        jl.append((jd, jh, jf, JH.make_hybrid_operator(jf, jh, dtype=jnp.float64)))
        td = TD.distribute_dofs(tm, p)
        th = TD.make_hanging_node_constraints(td)
        tl.append((td, th, TF.build_hybrid_format(td)))
    return jl, tl


def test_dofs_and_format_match_jax(hierarchy):
    jl, tl = hierarchy
    assert len(jl) == len(tl)
    for lvl, ((jd, jh, jf, _), (td, th, tf)) in enumerate(zip(jl, tl)):
        assert td.n_dofs == jd.n_dofs
        assert np.array_equal(td.cell_dofs, jd.cell_dofs), lvl
        assert np.array_equal(td.boundary_mask, jd.boundary_mask), lvl
        for f in ("slave", "masters", "weights"):
            assert np.array_equal(getattr(th, f), getattr(jh, f)), (lvl, f)
        for f in FORMAT_FIELDS:
            assert_tree_equal(
                host_tree(getattr(tf, f)), host_tree(getattr(jf, f)), f"level {lvl} {f}"
            )


def test_operator_tables_match_jax(hierarchy):
    jl, tl = hierarchy
    for lvl, ((_, _, _, jop), (_, th, tf)) in enumerate(zip(jl, tl)):
        tables, meta = TF.hybrid_operator_tables(tf, th)
        assert set(tables) == set(HybridOperator.TABLE_KEYS)
        for k in HybridOperator.TABLE_KEYS:
            assert_tree_equal(tables[k], host_tree(getattr(jop, k)), f"level {lvl} {k}")
        for k in HybridOperator.META_KEYS:
            assert meta[k] == getattr(jop, k), (lvl, k)


def test_transfer_tables_match_jax(hierarchy):
    jl, tl = hierarchy
    for lvl in range(1, len(jl)):
        jt = JHT.make_hybrid_transfer(
            jl[lvl][2], jl[lvl - 1][2], jl[lvl][3], jl[lvl - 1][3], dtype=jnp.float64
        )
        tables, meta = hybrid_transfer_tables(tl[lvl][2], tl[lvl - 1][2])
        assert set(tables) == set(HybridTransfer.TABLE_KEYS)
        for k in HybridTransfer.TABLE_KEYS:
            want = host_tree(getattr(jt, k))
            if k == "id_oct":  # drop the TPU lane-routing one-hot
                want = tuple(e[:2] for e in want)
            assert_tree_equal(tables[k], want, f"transfer {lvl} {k}")
        for k in HybridTransfer.META_KEYS:
            assert meta[k] == getattr(jt, k), (lvl, k)
