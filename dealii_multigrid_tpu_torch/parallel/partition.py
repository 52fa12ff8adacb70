"""Repartitioning policies for level hierarchies.

Capability mirror of the reference's policy zoo (multigrid_throughput.cc:
370-420, 2066-2175 and RepartitioningPolicyTools): partitions are cell->shard
maps over the Morton-ordered active cells (the space-filling-curve order both
p4est and this framework use), optionally weighted.

Includes the hanging-node Helper census (multigrid_throughput.cc:129-274) and
cell weighting (parallel::hanging_nodes_weighting, :276-292).
"""

from __future__ import annotations

import numpy as np

from ..mesh.dof import DoFHandler, make_hanging_node_constraints
from ..mesh.octree import AdaptiveMesh


def hanging_node_cell_flags(dofh: DoFHandler, hanging=None) -> np.ndarray:
    """True for cells constrained by hanging nodes (face or edge) —
    parallel::Helper::is_constrained equivalent."""
    if hanging is None:
        hanging = make_hanging_node_constraints(dofh)
    slave = np.zeros(dofh.n_dofs, bool)
    slave[hanging.slave] = True
    return slave[dofh.cell_dofs].any(axis=1)


def hanging_nodes_weighting(dofh: DoFHandler, weight: float, hanging=None) -> np.ndarray:
    """Cell weights: 10000 * weight for hanging-node-constrained cells, 10000
    otherwise (reference: multigrid_throughput.cc:276-292)."""
    flags = hanging_node_cell_flags(dofh, hanging)
    return np.where(flags, 10000.0 * weight, 10000.0)


def _weighted_morton_partition(weights: np.ndarray, n_shards: int) -> np.ndarray:
    """Split the Morton-ordered cell sequence into n_shards contiguous chunks
    of (approximately) equal total weight."""
    c = np.cumsum(weights)
    total = c[-1]
    return np.minimum(
        (c - weights / 2) / total * n_shards, n_shards - 1
    ).astype(np.int32)


def default_policy(mesh: AdaptiveMesh, n_shards: int) -> np.ndarray:
    """Equal cell counts along the Morton curve (DefaultPolicy)."""
    return _weighted_morton_partition(np.ones(mesh.n_cells), n_shards)


def cell_weight_policy(
    mesh: AdaptiveMesh, n_shards: int, weight: float, dofh: DoFHandler, hanging=None
) -> np.ndarray:
    """CellWeightPolicy-w: weighted Morton split with hanging-cell weights."""
    return _weighted_morton_partition(
        hanging_nodes_weighting(dofh, weight, hanging), n_shards
    )


def minimal_granularity_policy(
    mesh: AdaptiveMesh, n_shards: int, n_min_cells: int
) -> np.ndarray:
    """MinimalGranularityPolicy-n: use fewer shards so that every shard owns
    at least n_min_cells cells."""
    eff = max(min(n_shards, mesh.n_cells // max(n_min_cells, 1)), 1)
    return _weighted_morton_partition(np.ones(mesh.n_cells), eff)


def balanced_granularity_partition(
    levels: list[AdaptiveMesh], n_shards: int
) -> list[np.ndarray]:
    """BalancedGranularityPartitionPolicy (multigrid_throughput.cc:370-420):
    per coarse level, limit the shard count by a grain size
    min(200, 8 * n_cells / n_shards_prev + 1) cells/shard, with shard counts
    shrinking monotonically toward the coarse end."""
    parts: list[np.ndarray] = [None] * len(levels)
    n_prev = n_shards
    for l in range(len(levels) - 1, -1, -1):
        m = levels[l]
        if l == len(levels) - 1:
            n_eff = n_shards
        else:
            grain = min(200.0, 8.0 * m.n_cells / max(n_prev, 1) + 1.0)
            n_eff = int(max(min(n_prev, m.n_cells / grain), 1))
        parts[l] = _weighted_morton_partition(np.ones(m.n_cells), n_eff)
        n_prev = n_eff
    return parts


def first_child_policy(
    fine: AdaptiveMesh, coarse: AdaptiveMesh, fine_part: np.ndarray, n_shards: int
) -> np.ndarray:
    """FirstChildPolicy: each coarse cell goes to the shard of its first child
    in the fine mesh (or its own Morton position if not refined)."""
    from ..mesh.octree import morton_encode

    fidx = {}
    for lev in np.unique(fine.level):
        sel = np.nonzero(fine.level == lev)[0]
        codes = morton_encode(fine.anchor[sel])
        order = np.argsort(codes)
        fidx[int(lev)] = (codes[order], sel[order])

    out = np.zeros(coarse.n_cells, np.int32)
    for lev in np.unique(coarse.level):
        sel = np.nonzero(coarse.level == lev)[0]
        # identity cell in fine?
        codes_sorted, gidx = fidx.get(int(lev), (np.zeros(0, np.uint64), None))
        q = morton_encode(coarse.anchor[sel])
        if gidx is not None and len(codes_sorted):
            pos = np.minimum(np.searchsorted(codes_sorted, q), len(codes_sorted) - 1)
            hit = codes_sorted[pos] == q
            out[sel[hit]] = fine_part[gidx[pos[hit]]]
            rest = sel[~hit]
        else:
            rest = sel
        if len(rest):
            # first child at lev+1
            cs, gi = fidx.get(int(lev) + 1, (np.zeros(0, np.uint64), None))
            qc = morton_encode(coarse.anchor[rest] * 2)
            if gi is not None and len(cs):
                pos = np.minimum(np.searchsorted(cs, qc), len(cs) - 1)
                hit2 = cs[pos] == qc
                out[rest[hit2]] = fine_part[gi[pos[hit2]]]
    return out


def partition_hierarchy(
    policy_name: str,
    levels: list[AdaptiveMesh],
    n_shards: int,
    fine_dofh: DoFHandler | None = None,
    hanging=None,
) -> list[np.ndarray]:
    """Dispatch by PartitionerName (reference: multigrid_throughput.cc:2076-2175)."""
    name = policy_name or "DefaultPolicy"
    if name == "BalancedGranularityPartitionPolicy":
        return balanced_granularity_partition(levels, n_shards)
    if name.startswith("MinimalGranularityPolicy"):
        n_min = int(name.split("-")[1]) if "-" in name else 10
        return [minimal_granularity_policy(m, n_shards, n_min) for m in levels]
    if name.startswith("CellWeightPolicy"):
        w = float(name.split("-", 1)[1]) if "-" in name else 2.0
        parts = [default_policy(m, n_shards) for m in levels[:-1]]
        parts.append(
            cell_weight_policy(levels[-1], n_shards, w, fine_dofh, hanging)
        )
        return parts
    if name.startswith("FirstChildPolicy"):
        parts = [None] * len(levels)
        parts[-1] = default_policy(levels[-1], n_shards)
        for l in range(len(levels) - 2, -1, -1):
            parts[l] = first_child_policy(
                levels[l + 1], levels[l], parts[l + 1], n_shards
            )
        return parts
    return [default_policy(m, n_shards) for m in levels]
