"""Multigrid coarsening sequences.

Mirrors MGTransferGlobalCoarseningTools::create_geometric_coarsening_sequence
and create_polynomial_coarsening_sequence (reference usage:
multigrid_throughput.cc:1506-1510, 2219-2224) plus the coarse-end truncation
by MinLevel / MinNCells (multigrid_throughput.cc:2227-2260).
"""

from __future__ import annotations

from .octree import AdaptiveMesh


def geometric_coarsening_sequence(
    mesh: AdaptiveMesh,
    min_level: int = -1,
    min_n_cells: int = -1,
) -> list[AdaptiveMesh]:
    """All global-coarsening level meshes, coarsest first.

    Level k mesh = fine mesh with every cell of level > k replaced by its
    level-k ancestor.  Truncation: drop coarse levels below ``min_level`` or
    with fewer than ``min_n_cells`` cells (both from the JSON config).
    """
    seq = [mesh]
    while seq[-1].max_level > 0:
        seq.append(seq[-1].coarsened())
    seq = seq[::-1]  # coarsest first
    # keep from the FIRST tria satisfying the criterion; MinLevel takes
    # priority over MinNCells (else-if), and the finest mesh always stays
    # (reference: multigrid_throughput.cc:2232-2253)
    keep = len(seq) - 1
    for i, m in enumerate(seq[:-1]):
        n_global_levels = m.max_level + 1
        if min_level != -1:
            ok = min_level <= n_global_levels
        elif min_n_cells != -1:
            ok = m.n_cells >= min_n_cells
        else:
            ok = True
        if ok:
            keep = i
            break
    return seq[keep:]


def polynomial_coarsening_sequence(degree: int, kind: str = "bisect") -> list[int]:
    """Ascending degree sequence ending at ``degree``.

    bisect: p -> ceil(p/2) -> ... -> 1 (reference:
    PolynomialCoarseningSequenceType::bisect, multigrid_throughput.cc:1506-1510).
    """
    if kind == "bisect":
        seq = [degree]
        while seq[-1] > 1:
            seq.append((seq[-1] + 1) // 2)
        return seq[::-1]
    if kind == "go_to_one":
        # deal.II's go_to_one is the two-entry sequence [1, degree]
        return [1, degree] if degree > 1 else [1]
    if kind == "decrease_by_one":
        return list(range(1, degree + 1))
    raise ValueError(f"unknown polynomial coarsening kind {kind!r}")
