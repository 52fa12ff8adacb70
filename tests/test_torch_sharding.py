"""The port's device-major layout and sharding host functions equal the JAX
package's, and each rank's ghost-import plans stay surface-sized.

Host only, no processes: ``repartition_format``, ``default_cell_shard_map``,
``hybrid_level_shard_count`` and the device-major operator tables against
the JAX package's, integer for integer and bit for bit, at D in {2, 3, 8}
on quadrant r=3 p=2 and r=4 p=3, with the default layout and the cell maps
of CellWeightPolicy-2.0 and FirstChildPolicy.  The per-rank plans are built
with a stand-in group that answers no requests (only this rank's ghost
lists matter here): every ghost slot lies on another rank and is a real
slot (never a padding dummy), and on r=4 p=3 the fine level imports less
per vmult than it owns (on r=3 p=2 at D=8 a rank holds two patches of 5^3
slots, whose face planes alone outnumber them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence as j_gcs
from dealii_multigrid_tpu.ops import hybrid as JH
from dealii_multigrid_tpu.parallel import partition as JP, sharding as JS
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence as t_gcs
from dealii_multigrid_tpu_torch.ops import hybrid_format as TF
from dealii_multigrid_tpu_torch.ops.hybrid import HybridOperator
from dealii_multigrid_tpu_torch.ops.hybrid_rank import RankHybridOperator
from dealii_multigrid_tpu_torch.parallel import partition as TP, sharding as TS
from dealii_multigrid_tpu_torch.parallel.comm import SlotPart
from test_torch_tables import FORMAT_FIELDS, assert_tree_equal, host_tree

CASES = [(3, 2), (4, 3)]
POLICIES = ["", "CellWeightPolicy-2.0", "FirstChildPolicy"]
SHARDS = [2, 3, 8]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"quadrant-r{c[0]}-p{c[1]}")
def hierarchy(request):
    """Both packages' single-device levels of one hierarchy (coarsest first)."""
    r, p = request.param
    jl, tl = [], []
    for jm, tm in zip(j_gcs(JG.create("quadrant", 3, r)), t_gcs(TG.create("quadrant", 3, r))):
        jd = JD.distribute_dofs(jm, p)
        jl.append((jm, jd, JD.make_hanging_node_constraints(jd), JH.build_hybrid_format(jd)))
        td = TD.distribute_dofs(tm, p)
        tl.append((tm, td, TD.make_hanging_node_constraints(td), TF.build_hybrid_format(td)))
    return jl, tl


def cell_maps(meshes_j, meshes_t, dofh_j, dofh_t, policy, D):
    """Both packages' cell->rank maps per level for ``policy`` ('' = None)."""
    if not policy:
        return [None] * len(meshes_j), [None] * len(meshes_t)
    return (
        JP.partition_hierarchy(policy, meshes_j, D, dofh_j),
        TP.partition_hierarchy(policy, meshes_t, D, dofh_t),
    )


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_repartition_format_matches_jax(hierarchy, D, policy):
    jl, tl = hierarchy
    jmaps, tmaps = cell_maps([l[0] for l in jl], [l[0] for l in tl], jl[-1][1], tl[-1][1], policy, D)
    for lvl, (j, t, jm, tm) in enumerate(zip(jl, tl, jmaps, tmaps)):
        if jm is not None:
            assert np.array_equal(np.asarray(jm), np.asarray(tm)), (lvl, policy)
            if int(np.asarray(jm).max()) + 1 <= 1:
                continue
        jf = JH.repartition_format(j[3], D, jm)
        tf = TF.repartition_format(t[3], D, tm)
        for f in FORMAT_FIELDS + ("n_shards",):
            assert_tree_equal(host_tree(getattr(tf, f)), host_tree(getattr(jf, f)), f"L{lvl} {f}")
        assert (tf.patches_per_shard, tf.singles_per_shard, tf.shard_span) == (
            jf.patches_per_shard, jf.singles_per_shard, jf.shard_span)
        n_cells = t[0].n_cells
        assert np.array_equal(
            TS.default_cell_shard_map(tf, n_cells), JS.default_cell_shard_map(jf, n_cells)
        )


@pytest.mark.parametrize("D", SHARDS)
def test_level_shard_count_matches_jax(D):
    for n_cells in (0, 1, 7, 8 * D - 1, 8 * D, 8 * D + 1, 10_000):
        assert TS.hybrid_level_shard_count(n_cells, D) == JS.hybrid_level_shard_count(n_cells, D)
        assert TS.hybrid_level_shard_count(n_cells, D, 3) == JS.hybrid_level_shard_count(n_cells, D, 3)


@pytest.mark.parametrize("D", SHARDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_device_major_operator_tables_match_jax(hierarchy, D, policy):
    """The fine level's operator tables on the device-major format."""
    jl, tl = hierarchy
    jmaps, tmaps = cell_maps([l[0] for l in jl], [l[0] for l in tl], jl[-1][1], tl[-1][1], policy, D)
    (_, jd, jh, jf), (_, td, th, tf) = jl[-1], tl[-1]
    jf = JH.repartition_format(jf, D, jmaps[-1])
    tf = TF.repartition_format(tf, D, tmaps[-1])
    jop = JH.make_hybrid_operator(jf, jh, dtype=jnp.float64)
    tables, meta = TF.hybrid_operator_tables(tf, th)
    for k in HybridOperator.TABLE_KEYS:
        assert_tree_equal(tables[k], host_tree(getattr(jop, k)), k)
    for k in HybridOperator.META_KEYS:
        assert meta[k] == getattr(jop, k), k


class PlanOnly:
    """A stand-in group for host-side plan building: this rank's requests
    only (no peer asks it for anything)."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def host_alltoallv(self, send, send_counts):
        return np.zeros(0, np.int64), np.zeros(self.world, np.int64), len(send)


def rank_ghosts(op) -> np.ndarray:
    """Every ghost slot this rank's operator imports, over all stages."""
    return np.concatenate([np.zeros(0, np.int64)] + [imp.slots for imp in TS.operator_imports(op)])


@pytest.mark.parametrize("D", SHARDS)
def test_rank_plans_are_surface_sized(hierarchy, D):
    _, tl = hierarchy
    _, td, th, tf = tl[-1]
    tf = TF.repartition_format(tf, D)
    tables, meta = TF.hybrid_operator_tables(tf, th)
    for rank in range(D):
        op = RankHybridOperator.build(
            tables, meta, tf, "cpu", torch.float64, comm=PlanOnly(rank, D)
        )
        part = op.part
        assert part == SlotPart.of(tf, rank) and op.n_slots == part.span
        g = rank_ghosts(op)
        assert not part.own(g).any() and (g < tf.n_slots).all()
        assert (tf.slot_dof[g] < td.n_dofs).all(), "a padding dummy read as a ghost"
        if td.mesh.n_cells > 500:
            n_import = TS.operator_ghosts(op)
            assert n_import < part.span, (rank, n_import, part.span)
        # the owned masks cover exactly the rank's real DoFs once
        own_dofs = tf.slot_dof[part.lo : part.lo + part.span][
            np.asarray(op.owner.cpu()) > 0]
        assert (own_dofs < td.n_dofs).all()
