"""The port's local-smoothing pieces match the JAX package (CPU, float64).

Quadrant r=3 and r=4 at p=2 and p=4; each package builds its own LS
hierarchy on the active mesh from its own host code.  Integer tables
(level meshes, expected valences, edge sets, copy_to / copy_from tables,
ls_mode transfer tables) must be equal, the eigenvalue start vectors
bit-equal, and on consistent vectors (``fmt.from_global``) the ls_mode
prolong / restrict and the interface operators agree to 1e-12 relative and
one LS V-cycle to 1e-10 relative, its output slot-consistent.
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.ops import hybrid as JH
from dealii_multigrid_tpu.solvers import local_smoothing as JLS
from dealii_multigrid_tpu.utils.params import MultigridParameters as JMG
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.ops.hybrid_format import build_hybrid_format
from dealii_multigrid_tpu_torch.ops.hybrid_transfer import HybridTransfer
from dealii_multigrid_tpu_torch.solvers import local_smoothing as TLS
from dealii_multigrid_tpu_torch.utils.params import MultigridParameters as TMG

CASES = [(3, 2), (3, 4), (4, 2), (4, 4)]
CPU = torch.device("cpu")


def mg_data(cls):
    mg = cls()
    mg.smoother.degree = 3
    return mg


@functools.lru_cache(maxsize=None)
def hierarchies(r, p):
    """(JAX active dofh, JAX LS hierarchy, port active dofh, port LS hierarchy)."""
    jd = JD.distribute_dofs(JG.create("quadrant", 3, r), p)
    jls = JLS.build_local_smoothing_mg_hybrid(
        jd, JH.build_hybrid_format(jd, K=8), mg_data(JMG), dtype=jnp.float64
    )
    td = TD.distribute_dofs(TG.create("quadrant", 3, r), p)
    tls = TLS.build_local_smoothing_mg_hybrid(
        td, build_hybrid_format(td, K=8), mg_data(TMG), CPU, torch.float64
    )
    return jd, jls, td, tls


def rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-300))


def flat_leaves(v):
    if v is None:
        return [None]
    if isinstance(v, (tuple, list)):
        return [x for e in v for x in flat_leaves(e)]
    return [np.asarray(v)]


@pytest.mark.parametrize("r,p", CASES)
def test_level_meshes_edges_and_valence_match_jax(r, p):
    jd, _, td, tls = hierarchies(r, p)
    assert len(tls.levels) == jd.mesh.max_level + 1
    for l, lev in enumerate(tls.levels):
        jm = JLS.level_mesh(jd.mesh, l)
        tm = TLS.level_mesh(td.mesh, l)
        assert np.array_equal(tm.level, jm.level) and np.array_equal(tm.anchor, jm.anchor)
        jdl = JD.distribute_dofs(jm, p)
        tdl = TD.distribute_dofs(tm, p)
        jexp = JLS._expected_valence(jdl)
        assert np.array_equal(TLS._expected_valence(tdl), jexp)
        jval = np.bincount(jdl.cell_dofs.reshape(-1), minlength=jdl.n_dofs)
        jedge = (jval < jexp) & ~jdl.boundary_mask
        host = TLS.ls_level_host(td, build_hybrid_format(td, K=8), tm, l)
        assert np.array_equal(host.edge, jedge)
        assert np.array_equal(host.dofh.boundary_mask, jdl.boundary_mask | jedge)
        # the level operator is the identity exactly on boundary ∪ edge
        want_keep = host.fmt.from_global((~host.dofh.boundary_mask).astype(np.float64))
        want_keep[host.fmt.slot_dof == host.dofh.n_dofs] = 0.0
        keep = lev.keep.numpy()
        assert np.array_equal(keep[host.fmt.slot_dof < host.dofh.n_dofs],
                              want_keep[host.fmt.slot_dof < host.dofh.n_dofs])
    # the finest level has an edge where the quadrant's refinement stops
    assert float(tls.levels[-1].edge_ind.sum()) > 0


@pytest.mark.parametrize("r,p", CASES)
def test_copy_and_transfer_tables_match_jax(r, p):
    _, jls, _, tls = hierarchies(r, p)
    for jl, tl in zip(jls.levels, tls.levels):
        assert jl.rowcopy is None  # the row-copy layout variant is off on the CPU
        assert jl.n_dofs == tl.n_dofs
        for k in ("to_slots", "to_src", "from_slots", "from_src"):
            assert np.array_equal(getattr(tl, k).numpy(), np.asarray(getattr(jl, k))), k
        # each direction writes every slot at most once
        assert len(np.unique(tl.to_slots.numpy())) == len(tl.to_slots)
        assert len(np.unique(tl.from_slots.numpy())) == len(tl.from_slots)
        assert np.array_equal(tl.edge_ind.numpy(), np.asarray(jl.edge_ind))
        np.testing.assert_allclose(tl.inv_diag.numpy(), np.asarray(jl.inv_diag), rtol=1e-14)
    for jt, tt in zip(jls.transfers[1:], tls.transfers[1:]):
        assert jt.ls_mode and tt.ls_mode
        for k in HybridTransfer.TABLE_KEYS:
            jv = getattr(jt, k)
            if k == "id_oct":  # the JAX entries carry a TPU lane-routing third element
                jv = tuple(e[:2] for e in jv)
            got, want = flat_leaves(getattr(tt, k)), flat_leaves(jv)
            assert len(got) == len(want), k
            for g, w in zip(got, want):
                assert (g is None and w is None) or np.array_equal(g, w), k
        for k in HybridTransfer.META_KEYS:
            assert getattr(tt, k) == getattr(jt, k), k


@pytest.mark.parametrize("r,p", CASES)
def test_eig_start_vectors_bit_equal(r, p):
    _, jls, _, tls = hierarchies(r, p)
    for jl, tl in zip(jls.levels, tls.levels):
        assert torch.equal(tl.eig_b0, torch.as_tensor(np.array(jl.eig_b0)))
    for js, ts in zip(jls.smoothers[1:], tls.smoothers[1:]):
        assert abs(ts.theta - float(js.theta)) <= 1e-10 * abs(float(js.theta))
        assert abs(ts.delta - float(js.delta)) <= 1e-10 * abs(float(js.delta))


@pytest.mark.parametrize("r,p", CASES)
def test_ls_transfers_and_interfaces_match_jax(r, p):
    _, jls, _, tls = hierarchies(r, p)
    rng = np.random.default_rng(5)
    for l in range(1, len(tls.levels)):
        fine, coarse = tls.levels[l].fmt, tls.levels[l - 1].fmt
        jt, tt = jls.transfers[l], tls.transfers[l]
        uc = coarse.from_global(rng.standard_normal(coarse.dofh.n_dofs))
        assert rel_err(tt.prolong(torch.as_tensor(uc)), jt.prolong(jnp.asarray(uc))) <= 1e-12
        rf = fine.from_global(rng.standard_normal(fine.dofh.n_dofs))
        assert rel_err(tt.restrict(torch.as_tensor(rf)), jt.restrict(jnp.asarray(rf))) <= 1e-12
        u = fine.from_global(rng.standard_normal(fine.dofh.n_dofs))
        jl, tl = jls.levels[l], tls.levels[l]
        for name in ("interface_down", "interface_up", "vmult"):
            got = getattr(tl, name)(torch.as_tensor(u))
            assert rel_err(got, getattr(jl, name)(jnp.asarray(u))) <= 1e-12, (l, name)


@pytest.mark.parametrize("r,p", CASES)
def test_ls_vcycle_matches_jax(r, p):
    jd, jls, td, tls = hierarchies(r, p)
    fmt = JH.build_hybrid_format(jd, K=8)
    rng = np.random.default_rng(3)
    b = fmt.from_global(rng.standard_normal(jd.n_dofs))
    want = np.asarray(jax.jit(lambda m, v: m.vmult(v))(jls, jnp.asarray(b)))
    got = tls.vmult(torch.as_tensor(b)).numpy()
    assert rel_err(got, want) <= 1e-10
    # slot-consistent: every slot of a dof holds its representative's value
    tfmt = build_hybrid_format(td, K=8)
    assert np.array_equal(got, tfmt.from_global(got[tfmt.rep_slot]))


def test_ls_vcycle_leaves_no_reference_cycles():
    """Every vector of a V-cycle is freed when the call returns: a reference
    cycle (a recursive closure) would hold all levels' defects and
    solutions until the garbage collector runs, and on the card they would
    pile up into the solve's peak memory."""
    _, _, td, tls = hierarchies(3, 2)
    b = torch.as_tensor(build_hybrid_format(td, K=8).from_global(np.ones(td.n_dofs)))
    gc.collect()
    gc.disable()
    try:
        for _ in range(3):
            tls.vmult(b)
        assert gc.collect() == 0
    finally:
        gc.enable()
