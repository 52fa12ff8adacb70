"""Adaptive quad/octree meshes with 2:1 corner balance (p4est equivalent).

The reference delegates adaptive meshing to p4est via
``parallel::distributed::Triangulation`` with
``limit_level_difference_at_vertices`` smoothing + ``construct_multigrid_hierarchy``
(reference: multigrid_throughput.cc:2041-2046).  Here the mesh is a flat,
vectorised NumPy structure: every active cell is ``(level, anchor)`` with the
anchor in integer units of level-``level`` cells over the unit hypercube
``[0, 1]^dim`` mapped affinely onto the physical ``[lower, upper]^dim`` box.
Active cells are kept in Morton (z-)order at the finest lattice — the same
space-filling-curve order p4est partitions by.

Everything downstream (DoF enumeration, constraints, transfers, partitioning)
consumes the static integer arrays produced here; no mesh object ever reaches
the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_LEVEL = 20  # 3*20 = 60 Morton bits < 63


def _spread_bits_3(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so bit i moves to bit 3*i (Morton helper)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def _spread_bits_2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x << np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x << np.uint64(2))) & np.uint64(0x3333333333333333)
    x = (x | (x << np.uint64(1))) & np.uint64(0x5555555555555555)
    return x


def morton_encode(anchor: np.ndarray) -> np.ndarray:
    """Morton code of integer coordinates anchor[n, dim] (uint64)."""
    dim = anchor.shape[1]
    if dim == 3:
        return (
            _spread_bits_3(anchor[:, 0])
            | (_spread_bits_3(anchor[:, 1]) << np.uint64(1))
            | (_spread_bits_3(anchor[:, 2]) << np.uint64(2))
        )
    if dim == 2:
        return _spread_bits_2(anchor[:, 0]) | (
            _spread_bits_2(anchor[:, 1]) << np.uint64(1)
        )
    raise ValueError(f"unsupported dim {dim}")


@dataclass
class AdaptiveMesh:
    """A 2:1-corner-balanced adaptive quad/octree over a hypercube domain."""

    dim: int
    level: np.ndarray  # int32 [n_cells]
    anchor: np.ndarray  # int64 [n_cells, dim], units of level cells
    lower: float = -1.0
    upper: float = 1.0
    _codes: dict = field(default_factory=dict, repr=False)  # level -> sorted Morton codes

    # ------------------------------------------------------------------ basic
    @classmethod
    def unit(cls, dim: int, lower: float = -1.0, upper: float = 1.0) -> "AdaptiveMesh":
        return cls(
            dim=dim,
            level=np.zeros(1, dtype=np.int32),
            anchor=np.zeros((1, dim), dtype=np.int64),
            lower=lower,
            upper=upper,
        )

    @property
    def n_cells(self) -> int:
        return len(self.level)

    @property
    def max_level(self) -> int:
        return int(self.level.max(initial=0))

    @property
    def n_global_levels(self) -> int:
        """deal.II n_global_levels() = max tree level + 1."""
        return self.max_level + 1

    def h(self, level: np.ndarray | int) -> np.ndarray:
        """Physical cell edge length at a tree level."""
        return (self.upper - self.lower) / (1 << np.asarray(level))

    def centers(self) -> np.ndarray:
        """Physical cell centers [n_cells, dim]."""
        size = 1.0 / (1 << self.level.astype(np.int64))
        unit = (self.anchor + 0.5) * size[:, None]
        return self.lower + (self.upper - self.lower) * unit

    def vertices(self) -> np.ndarray:
        """Physical cell corner vertices [n_cells, 2**dim, dim]."""
        size = 1.0 / (1 << self.level.astype(np.int64))
        corners = np.stack(
            np.meshgrid(*([np.array([0, 1])] * self.dim), indexing="ij"), axis=-1
        ).reshape(-1, self.dim)
        unit = (self.anchor[:, None, :] + corners[None, :, :]) * size[:, None, None]
        return self.lower + (self.upper - self.lower) * unit

    # -------------------------------------------------------------- ordering
    def _sort_morton(self) -> None:
        shift = (MAX_LEVEL - self.level).astype(np.uint64)
        fine_anchor = self.anchor.astype(np.uint64) << shift[:, None]
        codes = morton_encode(fine_anchor.astype(np.int64))
        order = np.argsort(codes, kind="stable")
        self.level = self.level[order]
        self.anchor = self.anchor[order]
        self._codes = {}
        if hasattr(self, "_mgtpu_active_lookup"):
            del self._mgtpu_active_lookup  # invalidate cached lookups on mutation

    def _level_codes(self, l: int) -> np.ndarray:
        """Sorted Morton codes of active cells at exactly level l."""
        got = self._codes.get(l)
        if got is None:
            sel = self.level == l
            got = np.sort(morton_encode(self.anchor[sel]))
            self._codes[l] = got
        return got

    def _is_active(self, l: int, anchor: np.ndarray) -> np.ndarray:
        """Membership of level-l cells (anchor [n, dim]) in the active set."""
        codes = self._level_codes(l)
        if len(codes) == 0 or len(anchor) == 0:
            return np.zeros(len(anchor), dtype=bool)
        q = morton_encode(anchor)
        pos = np.searchsorted(codes, q)
        pos = np.minimum(pos, len(codes) - 1)
        return codes[pos] == q

    def active_index(self) -> dict:
        """Per-level map from Morton code to global active-cell index."""
        out = {}
        for l in np.unique(self.level):
            sel = np.nonzero(self.level == l)[0]
            codes = morton_encode(self.anchor[sel])
            order = np.argsort(codes)
            out[int(l)] = (codes[order], sel[order])
        return out

    def _codes_concat(self):
        """Concatenated per-level sorted Morton code tables (levels
        0..max_level) + offsets, cached alongside the per-level tables (the
        ``_codes = {}`` invalidation at every mutation site clears it too)."""
        got = self._codes.get("__concat__")
        if got is None:
            tables = [self._level_codes(l) for l in range(self.max_level + 1)]
            offs = np.zeros(len(tables) + 1, dtype=np.int64)
            np.cumsum([len(t) for t in tables], out=offs[1:])
            got = (np.concatenate(tables) if tables else
                   np.zeros(0, np.uint64), offs)
            self._codes["__concat__"] = got
        return got

    def covering_cell_level(
        self, query_level: int, anchor: np.ndarray, max_search_level: int | None = None
    ) -> np.ndarray:
        """For each level-``query_level`` lattice cell, the level of the active
        cell covering it from above (level <= query_level), or -1 if the region
        is refined finer / outside the domain."""
        n = len(anchor)
        out = np.full(n, -1, dtype=np.int32)
        top = query_level if max_search_level is None else max_search_level
        if self.dim == 3 and n:
            from . import native

            codes, offs = self._codes_concat()
            got = native.covering_cell_level_native(
                anchor, query_level, top, codes, offs
            )
            if got is not None:
                return got
        pending = np.arange(n)
        for q in range(top, -1, -1):
            if len(pending) == 0:
                break
            anc = anchor[pending] >> (query_level - q)
            hit = self._is_active(q, anc)
            out[pending[hit]] = q
            pending = pending[~hit]
        return out

    # ------------------------------------------------------------ refinement
    def refine(self, flags: np.ndarray) -> None:
        """Refine flagged cells (replace by 2**dim children), then re-establish
        2:1 corner balance (the p4est CONNECT_FULL /
        limit_level_difference_at_vertices behaviour the reference relies on)."""
        self._refine_no_balance(flags)
        self._balance()
        self._sort_morton()

    def refine_global(self, times: int = 1) -> None:
        for _ in range(times):
            self._refine_no_balance(np.ones(self.n_cells, dtype=bool))
        self._sort_morton()

    def _refine_no_balance(self, flags: np.ndarray) -> None:
        flags = np.asarray(flags, dtype=bool)
        keep_level = self.level[~flags]
        keep_anchor = self.anchor[~flags]
        par_level = self.level[flags]
        par_anchor = self.anchor[flags]
        nd = 1 << self.dim
        offsets = np.stack(
            np.meshgrid(*([np.array([0, 1])] * self.dim), indexing="ij"), axis=-1
        ).reshape(-1, self.dim)
        child_anchor = (par_anchor[:, None, :] * 2 + offsets[None, :, :]).reshape(
            -1, self.dim
        )
        child_level = np.repeat(par_level + 1, nd)
        self.level = np.concatenate([keep_level, child_level]).astype(np.int32)
        self.anchor = np.concatenate([keep_anchor, child_anchor]).astype(np.int64)
        self._codes = {}

    def _neighbor_offsets(self) -> np.ndarray:
        rng = [np.array([-1, 0, 1])] * self.dim
        offs = np.stack(np.meshgrid(*rng, indexing="ij"), axis=-1).reshape(-1, self.dim)
        return offs[np.any(offs != 0, axis=1)]

    def _balance(self) -> None:
        """Iteratively refine active cells that violate 2:1 corner balance:
        no active cell may share even a corner with an active cell two or more
        levels finer."""
        if self.dim == 3:
            from . import native

            got = native.balance_2to1(self.level, self.anchor)
            if got is not None:
                self.level, self.anchor = got[0], got[1]
                self._codes = {}
                return
        offsets = self._neighbor_offsets()
        while True:
            self._codes = {}
            flag = np.zeros(self.n_cells, dtype=bool)
            index = self.active_index()
            levels_present = sorted(index.keys(), reverse=True)
            for m in levels_present:
                if m < 2:
                    continue
                sel = self.level == m
                coords = self.anchor[sel]
                extent = 1 << m
                for off in offsets:
                    nb = coords + off[None, :]
                    valid = np.all((nb >= 0) & (nb < extent), axis=1)
                    nbv = nb[valid]
                    if len(nbv) == 0:
                        continue
                    # Finest active cell covering the neighbour from level m-1
                    # down; flag it if it is >= 2 levels coarser than m.
                    cov = self.covering_cell_level(m, nbv, max_search_level=m - 1)
                    bad = (cov >= 0) & (cov <= m - 2)
                    if not bad.any():
                        continue
                    bl = cov[bad]
                    banc = nbv[bad] >> (m - bl)[:, None]
                    for q in np.unique(bl):
                        qsel = bl == q
                        codes_sorted, gidx = index[int(q)]
                        qq = morton_encode(banc[qsel])
                        pos = np.searchsorted(codes_sorted, qq)
                        flag[gidx[pos]] = True
            if not flag.any():
                break
            self._refine_no_balance(flag)

    # ------------------------------------------------------------ coarsening
    def coarsened(self) -> "AdaptiveMesh":
        """One global-coarsening step: every cell at the deepest level is
        replaced by its parent (deduplicated); all other cells unchanged.
        This is the building block of the geometric coarsening sequence
        (reference: MGTransferGlobalCoarseningTools::
        create_geometric_coarsening_sequence, multigrid_throughput.cc:2219-2224).
        """
        k = self.max_level
        if k == 0:
            raise ValueError("cannot coarsen a level-0 mesh")
        fine = self.level == k
        par = np.unique(self.anchor[fine] >> 1, axis=0)
        level = np.concatenate([self.level[~fine], np.full(len(par), k - 1, np.int32)])
        anchor = np.concatenate([self.anchor[~fine], par])
        out = AdaptiveMesh(self.dim, level.astype(np.int32), anchor.astype(np.int64),
                           self.lower, self.upper)
        out._sort_morton()
        return out
