"""Partitioning-quality metrics for multigrid hierarchies.

Capability mirror of the reference's MGTools (include/mg_tools.h) with the
EXACT published definitions:

  * workload per (level, shard), workload efficiency = 1/imbalance
    (mg_tools.h:10-36), max workload path (mg_tools.h:311-314) and the
    node-level max path (ranks grouped into nodes of ``node_size``,
    mg_tools.h:296-309);
  * vertical communication cost (mg_tools.h:115-189): every owned coarse
    cell requires its 2^dim children on the finer level; a required child
    that exists in the fine mesh counts local/remote by comparing the fine
    owner with the requiring (coarse) shard;
  * horizontal communication cost (mg_tools.h:191-233): per level,
    owned cells vs ghost cells (cells of another shard vertex-adjacent to
    an owned cell), efficiency = (local + remote/2) / (local + remote);
  * memory consumption per level/shard (mg_tools.h:235-257, modelled as
    owned-cell DoF storage).

The reference resolves cross-shard ownership with an MPI consensus algorithm;
here partitions are static host arrays, so everything reduces to vectorised
NumPy over cell->shard maps (no Python loop is per-cell).

``print_multigrid_statistics`` mirrors the org-mode per-level min/max/avg
tables of mg_tools.h:267-512.
"""

from __future__ import annotations

import numpy as np

from ..mesh.octree import AdaptiveMesh, morton_encode
from ..utils.table import ConvergenceTable

# reference nodes have 48 ranks (mg_tools.h:302: ``(n_proc + 48 - 1) / 48``)
DEFAULT_NODE_SIZE = 48


def block_partition(n_cells: int, n_shards: int) -> np.ndarray:
    """Morton-order block partition (the default space-filling-curve
    partition, p4est-style): cell i -> shard floor(i * n_shards / n_cells)."""
    return (np.arange(n_cells, dtype=np.int64) * n_shards // max(n_cells, 1)).astype(
        np.int32
    )


# ---------------------------------------------------------------------------
# workload (mg_tools.h:39-79, 267-337)
# ---------------------------------------------------------------------------


def workload(levels: list[AdaptiveMesh], partitions: list[np.ndarray], n_shards: int):
    """Owned cells per (level, shard) — reference mg_tools.h:39-79."""
    out = np.zeros((len(levels), n_shards), dtype=np.int64)
    for l, (m, part) in enumerate(zip(levels, partitions)):
        out[l] = np.bincount(part, minlength=n_shards)
    return out


def workload_efficiency(
    levels: list[AdaptiveMesh], partitions: list[np.ndarray], n_shards: int
) -> float:
    """sum_l ideal / sum_l max_shard (reference mg_tools.h:10-36)."""
    w = workload(levels, partitions, n_shards)
    ideal = w.sum(axis=1) / n_shards
    path_max = w.max(axis=1).sum()
    return float(ideal.sum() / path_max) if path_max else 1.0


def workload_path_max(
    levels: list[AdaptiveMesh], partitions: list[np.ndarray], n_shards: int
) -> float:
    return float(workload(levels, partitions, n_shards).max(axis=1).sum())


def workload_path_max_node(
    levels: list[AdaptiveMesh],
    partitions: list[np.ndarray],
    n_shards: int,
    node_size: int = DEFAULT_NODE_SIZE,
) -> float:
    """Max workload path with shards aggregated into nodes of ``node_size``
    consecutive shards (reference mg_tools.h:296-309)."""
    w = workload(levels, partitions, n_shards)
    n_nodes = -(-n_shards // node_size)
    pad = n_nodes * node_size - n_shards
    if pad:
        w = np.concatenate([w, np.zeros((len(w), pad), np.int64)], axis=1)
    per_node = w.reshape(len(w), n_nodes, node_size).sum(axis=2)
    return float(per_node.max(axis=1).sum())


# ---------------------------------------------------------------------------
# vertical communication (mg_tools.h:115-189)
# ---------------------------------------------------------------------------


def vertical_communication_cost(
    levels: list[AdaptiveMesh], partitions: list[np.ndarray], n_shards: int
):
    """(local[L, D], remote[L, D]) required-children counts per (fine level,
    requiring shard) — the exact reference definition (mg_tools.h:115-189):
    each owned coarse cell requires ALL its 2^dim children on the finer mesh;
    a required child that exists as an active fine cell counts as local if
    the fine partition owns it on the same shard, remote otherwise.  Children
    that do not exist in the fine mesh (the cell is unrefined between the two
    levels) are skipped, exactly as the consensus algorithm returns
    invalid_unsigned_int for unowned indices."""
    L = len(levels)
    local = np.zeros((L, n_shards), dtype=np.int64)
    remote = np.zeros((L, n_shards), dtype=np.int64)
    for l in range(1, L):
        coarse, fine = levels[l - 1], levels[l]
        pc, pf = partitions[l - 1], partitions[l]
        # skip coarse cells whose children would exceed the fine tree depth
        # (mg_tools.h:155-156)
        sel = np.nonzero(coarse.level + 1 <= fine.max_level)[0]
        if len(sel) == 0:
            continue
        dim = coarse.dim
        nch = 1 << dim
        offs = np.stack(
            np.meshgrid(*([np.array([0, 1])] * dim), indexing="ij"), axis=-1
        ).reshape(-1, dim)
        child_anchor = (
            coarse.anchor[sel][:, None, :] * 2 + offs[None, :, :]
        ).reshape(-1, dim)
        child_level = np.repeat(coarse.level[sel] + 1, nch)
        req_shard = np.repeat(pc[sel], nch)
        owner = np.full(len(child_anchor), -1, np.int64)
        index = fine.active_index()
        for lev in np.unique(child_level):
            got = index.get(int(lev))
            if got is None:
                continue
            codes_sorted, gidx = got
            s = np.nonzero(child_level == lev)[0]
            q = morton_encode(child_anchor[s])
            pos = np.minimum(np.searchsorted(codes_sorted, q), len(codes_sorted) - 1)
            hit = codes_sorted[pos] == q
            owner[s[hit]] = pf[gidx[pos[hit]]]
        found = owner >= 0
        is_local = found & (owner == req_shard)
        is_remote = found & (owner != req_shard)
        local[l] = np.bincount(req_shard[is_local], minlength=n_shards)
        remote[l] = np.bincount(req_shard[is_remote], minlength=n_shards)
    return local, remote


def vertical_communication_efficiency(
    levels: list[AdaptiveMesh], partitions: list[np.ndarray], n_shards: int
) -> float:
    """sum local / (local + remote) (reference mg_tools.h:377-383)."""
    local, remote = vertical_communication_cost(levels, partitions, n_shards)
    tot = int(local.sum() + remote.sum())
    return float(local.sum() / tot) if tot else 1.0


# ---------------------------------------------------------------------------
# horizontal communication (mg_tools.h:191-233)
# ---------------------------------------------------------------------------


def _adjacency_pairs(m: AdaptiveMesh) -> tuple[np.ndarray, np.ndarray]:
    """Vertex-adjacency pairs (i, j) between active cells, each unordered
    pair listed at least once, fully vectorised.  Every adjacency where
    cell i is at the same or finer level than cell j is found by querying
    i's 26 (3^dim-1) neighbour anchors with the covering-cell lookup, which
    captures equal-level and coarser neighbours; finer neighbours of i are
    the mirror image found from the finer side."""
    offs = m._neighbor_offsets()
    index = m.active_index()
    src_all, dst_all = [], []
    for lev in np.unique(m.level):
        sel = np.nonzero(m.level == lev)[0]
        coords = m.anchor[sel]
        extent = 1 << int(lev)
        for off in offs:
            nb = coords + off[None, :]
            valid_mask = np.all((nb >= 0) & (nb < extent), axis=1)
            vsel = np.nonzero(valid_mask)[0]
            if len(vsel) == 0:
                continue
            nbv = nb[vsel]
            # covering active cell at level <= lev (equal or coarser)
            rem = np.arange(len(vsel))
            covered = np.full(len(vsel), -1, np.int64)
            for q in range(int(lev), -1, -1):
                if len(rem) == 0:
                    break
                got = index.get(q)
                if got is None:
                    continue
                codes_sorted, gidx = got
                anc = nbv[rem] >> (int(lev) - q)
                qq = morton_encode(anc)
                pos = np.minimum(
                    np.searchsorted(codes_sorted, qq), len(codes_sorted) - 1
                )
                hit = codes_sorted[pos] == qq
                covered[rem[hit]] = gidx[pos[hit]]
                rem = rem[~hit]
            found = covered >= 0
            src_all.append(sel[vsel[found]])
            dst_all.append(covered[found])
    if not src_all:
        z = np.zeros(0, np.int64)
        return z, z
    return np.concatenate(src_all), np.concatenate(dst_all)


def horizontal_communication_cost(
    levels: list[AdaptiveMesh], partitions: list[np.ndarray], n_shards: int
):
    """(local[L, D], remote[L, D]): owned cells and ghost cells per (level,
    shard).  A cell owned by shard a is a ghost on every OTHER shard b that
    owns a vertex-adjacent cell (deal.II's one-deep ghost layer,
    mg_tools.h:218-230); counted once per distinct (cell, b)."""
    L = len(levels)
    local = np.zeros((L, n_shards), dtype=np.int64)
    remote = np.zeros((L, n_shards), dtype=np.int64)
    for l, (m, part) in enumerate(zip(levels, partitions)):
        local[l] = np.bincount(part, minlength=n_shards)
        src, dst = _adjacency_pairs(m)
        if len(src) == 0:
            continue
        pa, pb = part[src], part[dst]
        diff = pa != pb
        # cell src is ghost on shard pb; cell dst is ghost on shard pa
        cell = np.concatenate([src[diff], dst[diff]])
        on = np.concatenate([pb[diff], pa[diff]])
        keys = np.unique(cell.astype(np.int64) * n_shards + on)
        remote[l] = np.bincount(
            (keys % n_shards).astype(np.int64), minlength=n_shards
        )
    return local, remote


def horizontal_communication_efficiency(
    levels: list[AdaptiveMesh], partitions: list[np.ndarray], n_shards: int
) -> float:
    """(local + remote/2) / (local + remote), totals over all levels
    (reference mg_tools.h:443-449, integer halving included)."""
    local, remote = horizontal_communication_cost(levels, partitions, n_shards)
    n_local, n_remote = int(local.sum()), int(remote.sum())
    tot = n_local + n_remote
    return float((n_local + n_remote // 2) / tot) if tot else 1.0


# ---------------------------------------------------------------------------
# memory (mg_tools.h:235-257)
# ---------------------------------------------------------------------------


def memory_cost(
    levels: list[AdaptiveMesh],
    partitions: list[np.ndarray],
    n_shards: int,
    degree: int,
    bytes_per_dof: int = 4,
):
    """Modelled memory per (level, shard): owned-cell DoF storage."""
    out = np.zeros((len(levels), n_shards), dtype=np.float64)
    for l, (m, part) in enumerate(zip(levels, partitions)):
        nloc = (degree + 1) ** m.dim
        out[l] = np.bincount(part, minlength=n_shards) * nloc * bytes_per_dof
    return out


def memory_consumption(levels: list[AdaptiveMesh], degree: int, bytes_per_dof: int = 4):
    """Total memory model over all levels (reference mg_tools.h:235-257)."""
    total = 0
    for m in levels:
        nloc = (degree + 1) ** m.dim
        total += m.n_cells * nloc * bytes_per_dof
    return total


# ---------------------------------------------------------------------------
# summary + per-level tables (mg_tools.h:267-512)
# ---------------------------------------------------------------------------


def multigrid_statistics(
    levels: list[AdaptiveMesh],
    n_shards: int,
    degree: int,
    partitions: list[np.ndarray] | None = None,
    node_size: int = DEFAULT_NODE_SIZE,
) -> dict:
    """The summary values of reference MGTools::print_multigrid_statistics
    (mg_tools.h:267-512)."""
    if partitions is None:
        partitions = [block_partition(m.n_cells, n_shards) for m in levels]
    return {
        "workload_eff": workload_efficiency(levels, partitions, n_shards),
        "workload_path_max": workload_path_max(levels, partitions, n_shards),
        "workload_path_max_node": workload_path_max_node(
            levels, partitions, n_shards, node_size
        ),
        "vertical_eff": vertical_communication_efficiency(
            levels, partitions, n_shards
        ),
        "horizontal_eff": horizontal_communication_efficiency(
            levels, partitions, n_shards
        ),
        "mem_total": memory_consumption(levels, degree),
    }


def _min_max_avg_table(stream, per_shard_by_level, names):
    """Per-level min/max/avg org-mode-style table over shards
    (mg_tools.h:324-334 et al.)."""
    table = ConvergenceTable()
    L = per_shard_by_level[0].shape[0]
    n_shards = per_shard_by_level[0].shape[1]
    for i in range(L):
        table.new_row()
        table.add_value("level", i)
        for arr, name in zip(per_shard_by_level, names):
            row = arr[i]
            table.add_value(f"{name}_min", int(row.min()))
            table.add_value(f"{name}_max", int(row.max()))
            table.add_value(f"{name}_avg", int(row.sum() // n_shards))
    table.write_text(stream)


def print_multigrid_statistics(
    levels: list[AdaptiveMesh],
    n_shards: int,
    degree: int,
    partitions: list[np.ndarray] | None = None,
    node_size: int = DEFAULT_NODE_SIZE,
    stream=None,
) -> dict:
    """Reference-format statistics print: summary line + per-level
    min/max/avg tables for workload, vertical, horizontal and memory
    (mg_tools.h:267-512).  Returns the summary dict."""
    import sys

    out = stream or sys.stdout
    if partitions is None:
        partitions = [block_partition(m.n_cells, n_shards) for m in levels]

    result = {}

    w = workload(levels, partitions, n_shards)
    eff = workload_efficiency(levels, partitions, n_shards)
    pmax = workload_path_max(levels, partitions, n_shards)
    pmax_node = workload_path_max_node(levels, partitions, n_shards, node_size)
    result["workload_eff"] = eff
    result["workload_path_max"] = pmax
    result["workload_path_max_node"] = pmax_node
    print("Workload:", file=out)
    print(
        f"  efficiency: {eff:g} max path: {pmax:g} max path node: {pmax_node:g}",
        file=out,
    )
    _min_max_avg_table(out, [w], ["n_cells"])
    print(file=out)

    vl, vr = vertical_communication_cost(levels, partitions, n_shards)
    tot = int(vl.sum() + vr.sum())
    veff = float(vl.sum() / tot) if tot else 1.0
    result["vertical_eff"] = veff
    print("Vertical communication:", file=out)
    print(f"  efficiency: {veff:g} total: {int(vr.sum())}", file=out)
    _min_max_avg_table(out, [vl, vr], ["n_local_cells", "n_remote_cells"])
    print(file=out)

    hl, hr = horizontal_communication_cost(levels, partitions, n_shards)
    n_local, n_remote = int(hl.sum()), int(hr.sum())
    heff = (
        float((n_local + n_remote // 2) / (n_local + n_remote))
        if (n_local + n_remote)
        else 1.0
    )
    result["horizontal_eff"] = heff
    print("Horizontal communication:", file=out)
    print(f"  efficiency: {heff:g} total: {n_remote}", file=out)
    _min_max_avg_table(out, [hl, hr], ["n_local_cells", "n_remote_cells"])
    print(file=out)

    mem = memory_cost(levels, partitions, n_shards, degree)
    result["mem_total"] = float(mem.sum())
    print("Memory consumption:", file=out)
    print(f"  total: {result['mem_total']:g}", file=out)
    _min_max_avg_table(out, [mem], ["mem"])
    print(file=out)

    return result
