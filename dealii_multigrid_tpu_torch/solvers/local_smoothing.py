"""Geometric multigrid with local smoothing (HMG-local, HPMG-local), on torch.

Mirror of the JAX package's hybrid-engine local-smoothing path
(dealii_multigrid_tpu/solvers/local_smoothing.py; reference
solve_with_local_smoothing, multigrid_throughput.cc:1670-1873, on deal.II's
Multigrid + MGTransferMatrixFree and the refinement-edge interface
operators of include/operator.h:152-226):

  * level l's mesh holds every tree cell at level exactly l (active cells
    there and the level-l ancestors of finer ones), so it covers only the
    region refined to at least l and has no hanging nodes;
  * the level operator is the hybrid operator with Dirichlet set = domain
    boundary plus refinement edge ("edge": DoFs with fewer level cells
    around them than a region without an inner boundary would give), so it
    is the identity there (operator.h:152-183);
  * the V-cycle carries the global defect over the levels: the residual on
    edge rows flows to the coarser level with the restriction
    (``interface_down``, operator.h:191-205) and the prolongated coarse
    solution couples back into the post-smoothing right-hand side
    (``interface_up``, operator.h:207-226);
  * copy_to_mg / copy_from_mg move values between the active mesh's slot
    layout and each level's through the active cells of that level.

The host half (level meshes, edge sets, copy tables) is NumPy; the device
half runs on the levels' device.  The JAX package's row-copy layout variant
and its eigenvalue extrapolation and cache are TPU workarounds and are not
carried.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.dof import Constraints, DoFHandler, distribute_dofs, local_node_indices
from ..mesh.octree import AdaptiveMesh, morton_encode
from ..ops import element
from ..ops.hybrid import HybridOperator, make_hybrid_operator
from ..ops.hybrid_format import HybridFormat, build_hybrid_format, slots_of
from ..ops.hybrid_transfer import make_hybrid_transfer
from .chebyshev import ChebyshevSmoother, estimate_eigenvalue_ranges
from .coarse import make_algebraic_solver

# ---------------------------------------------------------------------------
# host half
# ---------------------------------------------------------------------------


def level_mesh(active: AdaptiveMesh, l: int) -> AdaptiveMesh:
    """Cells at tree level exactly l: active cells at l plus level-l ancestors
    of finer active cells."""
    parts = [active.anchor[active.level == l]]
    for lf in np.unique(active.level):
        if lf > l:
            parts.append(active.anchor[active.level == lf] >> (lf - l))
    anchors = np.unique(np.concatenate(parts), axis=0)
    m = AdaptiveMesh(
        active.dim,
        np.full(len(anchors), l, np.int32),
        anchors.astype(np.int64),
        active.lower,
        active.upper,
    )
    m._sort_morton()
    return m


def _expected_valence(dofh: DoFHandler) -> np.ndarray:
    """Number of level-mesh cells that WOULD contain each DoF if the level
    region had no boundary except the domain boundary."""
    mesh, p, dim = dofh.mesh, dofh.degree, dofh.dim
    loc = local_node_indices(dim, p)
    on_face = (loc == 0) | (loc == p)              # [nloc, dim]
    lvl = mesh.level.astype(np.int64)
    out = np.zeros(dofh.n_dofs, dtype=np.int64)
    # per (cell, node) and axis: 1 if the node is interior to the cell in
    # that axis, else 2 unless the face is on the domain boundary
    anchors = mesh.anchor
    extent = (1 << lvl)[:, None]                   # [ncell, 1]
    fac = np.ones((mesh.n_cells, len(loc)), dtype=np.int64)
    for d in range(dim):
        lo_bd = (anchors[:, d : d + 1] == 0) & (loc[None, :, d] == 0)
        hi_bd = (anchors[:, d : d + 1] == extent - 1) & (loc[None, :, d] == p)
        f = np.where(on_face[None, :, d], 2, 1)
        f = np.where(lo_bd | hi_bd, 1, f)
        fac *= f
    out[dofh.cell_dofs.reshape(-1)] = fac.reshape(-1)
    return out


def _cheb_interval(max_eigenvalue: float, smoothing_range: float):
    """(theta, delta) of the Chebyshev interval [max / range, max]."""
    min_eigenvalue = max_eigenvalue / smoothing_range
    theta = 0.5 * (max_eigenvalue + min_eigenvalue)
    delta = 0.5 * (max_eigenvalue - min_eigenvalue)
    return float(theta), float(delta)


@dataclass
class LSLevelHost:
    """Host tables of one local-smoothing level."""

    dofh: DoFHandler            # boundary_mask holds boundary ∪ edge
    fmt: HybridFormat
    edge: np.ndarray            # bool [n_dofs]: refinement-edge DoFs
    diag: np.ndarray            # [n_dofs] operator diagonal, 1 on boundary ∪ edge
    # copy_to_mg: level slots <- active-layout representative slots
    to_slots: np.ndarray
    to_src: np.ndarray
    # copy_from_mg: active-layout slots <- level representative slots
    from_slots: np.ndarray
    from_src: np.ndarray


def ls_level_host(
    active_dofh: DoFHandler, active_fmt: HybridFormat, lm: AdaptiveMesh, l: int,
    K: int = 8,
) -> LSLevelHost:
    """Level ``l``'s DoFs, edge set, hybrid layout, diagonal and copy tables."""
    active = active_dofh.mesh
    p = active_dofh.degree
    dim = active.dim
    dofh = distribute_dofs(lm, p)
    valence = np.bincount(dofh.cell_dofs.reshape(-1), minlength=dofh.n_dofs)
    edge = (valence < _expected_valence(dofh)) & ~dofh.boundary_mask
    # identity rows of the level operator = boundary ∪ edge
    # (operator.h:152-183): fold the edge set into the Dirichlet mask
    dofh.boundary_mask = dofh.boundary_mask | edge
    fmt = build_hybrid_format(dofh, K=K)
    elem = element.laplace_element_matrix(dim, p)
    scale = lm.h(lm.level).astype(np.float64) ** (dim - 2)
    diag = np.bincount(
        dofh.cell_dofs.reshape(-1),
        weights=(scale[:, None] * np.diag(elem)[None, :]).reshape(-1),
        minlength=dofh.n_dofs,
    )
    diag[dofh.boundary_mask] = 1.0

    # copy maps: active cells at level l <-> level-mesh cells; the tables
    # list ALL slots of each copied dof (slots_of), so both directions write
    # slot-consistent vectors, and each direction's slots are unique
    sel = np.nonzero(active.level == l)[0]
    if len(sel):
        codes = morton_encode(lm.anchor)
        order = np.argsort(codes)
        pos = order[np.searchsorted(codes[order], morton_encode(active.anchor[sel]))]
        ld = dofh.cell_dofs[pos].reshape(-1).astype(np.int64)
        gd = active_dofh.cell_dofs[sel].reshape(-1).astype(np.int64)
        uniq_ld, first = np.unique(ld, return_index=True)
        uniq_gd = gd[first]
        _, to_flat, to_grp = slots_of(fmt, uniq_ld)
        to_src = active_fmt.rep_slot[uniq_gd][to_grp]
        _, fr_flat, fr_grp = slots_of(active_fmt, uniq_gd)
        fr_src = fmt.rep_slot[uniq_ld][fr_grp]
    else:
        to_flat = to_src = fr_flat = fr_src = np.zeros(0, np.int64)
    return LSLevelHost(dofh, fmt, edge, diag, to_flat, to_src, fr_flat, fr_src)


def no_constraints(n_dofs: int) -> Constraints:
    """Level meshes are conforming: an empty hanging-node table."""
    return Constraints(
        n_dofs, np.zeros(0, np.int32), np.zeros((0, 1), np.int32), np.zeros((0, 1))
    )


# ---------------------------------------------------------------------------
# device half
# ---------------------------------------------------------------------------


@dataclass
class LSHybridLevel:
    """One local-smoothing level on the hybrid patch engine."""

    op: HybridOperator          # identity on boundary ∪ edge
    edge_ind: torch.Tensor      # [n_slots] 1 on refinement-edge slots
    inv_diag: torch.Tensor      # slot layout
    eig_b0: torch.Tensor        # eigenvalue-estimation start vector
    to_slots: torch.Tensor
    to_src: torch.Tensor
    from_slots: torch.Tensor
    from_src: torch.Tensor
    n_dofs: int                 # n_slots of the level layout
    fmt: HybridFormat           # host layout (its dofh: the level's DoFs)

    @property
    def keep(self) -> torch.Tensor:
        return self.op.dirichlet_keep

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        return self.op.vmult(u)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.op.dot(x, y)

    def _raw_exchanged(self, u: torch.Tensor) -> torch.Tensor:
        return self.op.exchange(self.op.cell_apply_raw(u))

    def interface_down(self, u: torch.Tensor) -> torch.Tensor:
        """Edge rows of the raw operator applied to an interior-supported
        function (operator.h:191-205)."""
        return self._raw_exchanged(u * self.keep) * self.edge_ind

    def interface_up(self, u: torch.Tensor) -> torch.Tensor:
        """Interior rows of the raw operator applied to the edge part
        (operator.h:207-226)."""
        return self._raw_exchanged(u * self.edge_ind) * self.keep


@dataclass(frozen=True)
class LocalSmoothingMGHybrid:
    """The local-smoothing V-cycle on hybrid slot vectors: input and output
    are in the ACTIVE mesh's slot layout (api.build_level_hybrid)."""

    levels: tuple               # LSHybridLevel, coarsest first
    smoothers: tuple            # smoothers[0] unused (None)
    transfers: tuple            # ls_mode HybridTransfer; transfers[l]: l-1 -> l
    coarse_solve: object        # called as coarse_solve(b)
    n_dofs_global: int          # n_slots of the active layout

    def vmult(self, r_active: torch.Tensor) -> torch.Tensor:
        # copy_to_mg, zeroing the level's boundary ∪ edge rows
        defect = []
        for lev in self.levels:
            d = r_active.new_zeros(lev.n_dofs)
            d[lev.to_slots] = r_active[lev.to_src]
            defect.append(d * lev.keep)
        sols = [None] * len(self.levels)
        self._v_step(len(self.levels) - 1, defect[-1], defect, sols)
        # copy_from_mg one level at a time, coarsest first, so the finest
        # level holding a dof writes it last; within a level the slots are
        # unique (one scatter over all levels would leave the order of
        # duplicate writes undefined on CUDA)
        out = r_active.new_zeros(self.n_dofs_global)
        for lev, u in zip(self.levels, sols):
            out[lev.from_slots] = u[lev.from_src]
        return out

    def _v_step(self, l: int, d_l: torch.Tensor, defect: list, sols: list) -> torch.Tensor:
        """Level l's visit; fills sols[l].  A method, not a nested closure:
        a recursive closure is a reference cycle that would keep every
        level's vectors alive until the garbage collector runs."""
        lev = self.levels[l]
        if l == 0:
            sols[0] = self.coarse_solve(d_l)
            return sols[0]
        sm = self.smoothers[l]
        d_smooth = d_l * lev.keep
        u = sm.vmult(d_smooth)
        t = d_smooth - lev.vmult(u)
        t = t * lev.keep + (d_l - lev.interface_down(u)) * lev.edge_ind
        # deal.II: defect[l-1] += restrict_and_add(t)
        d_c = defect[l - 1] + self.transfers[l].restrict(t)
        u = u + self.transfers[l].prolong(self._v_step(l - 1, d_c, defect, sols))
        b_eff = (d_smooth - lev.interface_up(u)) * lev.keep + u * (1.0 - lev.keep)
        sols[l] = sm.step(u, b_eff)
        return sols[l]


def build_local_smoothing_mg_hybrid(
    active_dofh: DoFHandler,
    active_fmt: HybridFormat,
    mg_data,
    device: torch.device,
    dtype: torch.dtype,
    min_level: int = 0,
) -> LocalSmoothingMGHybrid:
    """Hybrid-engine LS hierarchy on one device; ``active_fmt`` is the
    active mesh's layout, the one the preconditioner reads and writes.

    Order as in the JAX package's function: the levels (one NumPy
    generator, seed 42, draws the eigenvalue start vectors in level
    order), the ls_mode transfers, every level's eigenvalue estimate with
    the ownership dot, Chebyshev at 1.2 x lambda_max, the algebraic coarse
    solve on the coarsest level (dense up to 8,000 DoFs, AMG above)."""
    active = active_dofh.mesh
    assert active.dim == 3, "hybrid local smoothing is 3D (2D is ROADMAP item 11)"
    lmin = max(min_level, 0)
    rng = np.random.default_rng(42)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    hosts, levels = [], []
    for l in range(lmin, active.max_level + 1):
        h = ls_level_host(active_dofh, active_fmt, level_mesh(active, l), l)
        n = h.dofh.n_dofs
        levels.append(LSHybridLevel(
            op=make_hybrid_operator(h.fmt, no_constraints(n), device, dtype),
            edge_ind=dev(h.fmt.from_global(h.edge.astype(np.float64))),
            inv_diag=dev(h.fmt.from_global(1.0 / h.diag)),
            eig_b0=dev(h.fmt.from_global(rng.standard_normal(n))),
            to_slots=idx(h.to_slots),
            to_src=idx(h.to_src),
            from_slots=idx(h.from_slots),
            from_src=idx(h.from_src),
            n_dofs=h.fmt.n_slots,
            fmt=h.fmt,
        ))
        hosts.append(h)

    transfers: list = [None]
    for i in range(1, len(levels)):
        transfers.append(make_hybrid_transfer(
            hosts[i].fmt, hosts[i - 1].fmt, levels[i].op, levels[i - 1].op, ls_mode=True
        ))
    sm = mg_data.smoother
    ranges = estimate_eigenvalue_ranges(
        [lv.op for lv in levels[1:]],
        [lv.inv_diag for lv in levels[1:]],
        [lv.eig_b0 for lv in levels[1:]],
        n_iterations=sm.eig_cg_n_iterations,
        use_op_dot=True,
    )
    smoothers: list = [None]
    for lv, rg in zip(levels[1:], ranges):
        smoothers.append(ChebyshevSmoother(
            lv.op, lv.inv_diag, sm.degree,
            *_cheb_interval(1.2 * rg[0], sm.smoothing_range),  # deal.II safety factor
        ))
    h0 = hosts[0]
    coarse = make_algebraic_solver(
        h0.dofh, no_constraints(h0.dofh.n_dofs), dtype, device, mg_data,
        to_idx=idx(h0.fmt.rep_slot), from_idx=idx(h0.fmt.slot_dof),
    )
    return LocalSmoothingMGHybrid(
        levels=tuple(levels),
        smoothers=tuple(smoothers),
        transfers=tuple(transfers),
        coarse_solve=coarse,
        n_dofs_global=active_fmt.n_slots,
    )
