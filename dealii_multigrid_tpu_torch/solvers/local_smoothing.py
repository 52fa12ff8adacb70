"""Geometric multigrid with local smoothing (HMG-local, HPMG-local), on torch.

Mirror of the JAX package's local-smoothing paths
(dealii_multigrid_tpu/solvers/local_smoothing.py; reference
solve_with_local_smoothing, multigrid_throughput.cc:1670-1873, on deal.II's
Multigrid + MGTransferMatrixFree and the refinement-edge interface
operators of include/operator.h:152-226):

  * level l's mesh holds every tree cell at level exactly l (active cells
    there and the level-l ancestors of finer ones), so it covers only the
    region refined to at least l and has no hanging nodes;
  * the level operator is the identity on the domain boundary plus the
    refinement edge ("edge": DoFs with fewer level cells around them than a
    region without an inner boundary would give) (operator.h:152-183);
  * the V-cycle carries the global defect over the levels: the residual on
    edge rows flows to the coarser level with the restriction
    (``interface_down``, operator.h:191-205) and the prolongated coarse
    solution couples back into the post-smoothing right-hand side
    (``interface_up``, operator.h:207-226);
  * copy_to_mg / copy_from_mg move values between the active mesh's vector
    and each level's through the active cells of that level.

Two engines share the cycle (``_LSCycle``): the hybrid patch engine in 3D
(``LocalSmoothingMGHybrid``, vectors in the active mesh's slot layout) and
the gather engine in 2D (``LocalSmoothingMG``, vectors in the global
layout).  The host half (level meshes, edge sets, copy tables) is NumPy.
The JAX package's row-copy layout variant and its eigenvalue extrapolation
and cache are TPU workarounds and are not carried.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..mesh.dof import Constraints, DoFHandler, distribute_dofs, local_node_indices
from ..mesh.octree import AdaptiveMesh, morton_encode
from ..ops import element, tensor
from ..ops.fixed_order import FixedOrderSum
from ..ops.hybrid import HybridOperator, make_hybrid_operator
from ..ops.hybrid_format import HybridFormat, build_hybrid_format, slots_of
from ..ops.hybrid_transfer import make_hybrid_transfer
from .chebyshev import ChebyshevSmoother, estimate_eigenvalue_ranges
from .coarse import make_algebraic_solver
from .multigrid import prolong_add, residual, untimed

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


def level_dofs(lm: AdaptiveMesh, p: int) -> tuple[DoFHandler, np.ndarray, np.ndarray]:
    """A level mesh's DoFs, its refinement-edge set (bool [n_dofs]) and its
    operator diagonal (1 on boundary and edge rows; level meshes have no
    hanging nodes)."""
    dim = lm.dim
    dofh = distribute_dofs(lm, p)
    valence = np.bincount(dofh.cell_dofs.reshape(-1), minlength=dofh.n_dofs)
    edge = (valence < _expected_valence(dofh)) & ~dofh.boundary_mask
    elem = element.laplace_element_matrix(dim, p)
    scale = lm.h(lm.level).astype(np.float64) ** (dim - 2)
    diag = np.bincount(
        dofh.cell_dofs.reshape(-1),
        weights=(scale[:, None] * np.diag(elem)[None, :]).reshape(-1),
        minlength=dofh.n_dofs,
    )
    diag[dofh.boundary_mask | edge] = 1.0
    return dofh, edge, diag


def _copy_cells(active: AdaptiveMesh, lm: AdaptiveMesh, l: int):
    """(active cells at level l, their positions in the level mesh)."""
    sel = np.nonzero(active.level == l)[0]
    codes = morton_encode(lm.anchor)
    order = np.argsort(codes)
    pos = order[np.searchsorted(codes[order], morton_encode(active.anchor[sel]))]
    return sel, pos


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
    dofh, edge, diag = level_dofs(lm, active_dofh.degree)
    # identity rows of the level operator = boundary ∪ edge
    # (operator.h:152-183): fold the edge set into the Dirichlet mask
    dofh.boundary_mask = dofh.boundary_mask | edge
    fmt = build_hybrid_format(dofh, K=K)

    # copy maps: active cells at level l <-> level-mesh cells; the tables
    # list ALL slots of each copied dof (slots_of), so both directions write
    # slot-consistent vectors, and each direction's slots are unique
    sel, pos = _copy_cells(active_dofh.mesh, lm, l)
    if len(sel):
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


def _edge_down(lev, t: torch.Tensor, d_l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The defect that flows down: interior rows of the smoothed residual,
    edge rows of the level defect minus the interface operator."""
    return t * lev.keep + (d_l - lev.interface_down(u)) * lev.edge_ind


def _edge_up(lev, d_smooth: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Post-smoothing right-hand side with the edge values coupled back."""
    return (d_smooth - lev.interface_up(u)) * lev.keep + u * (1.0 - lev.keep)


def _restrict_add(transfer, d_c: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    # deal.II: defect[l-1] += restrict_and_add(t)
    return d_c + transfer.restrict(t)


class _LSCycle:
    """The local-smoothing V-cycle both engines share; a subclass gives the
    levels, smoothers, transfers, coarse solve and phase hook, and the two
    copies between the active mesh's vector and the levels'."""

    def vmult(self, r_active: torch.Tensor) -> torch.Tensor:
        ph = self.hook
        defect = ph("to_mg", self.copy_to_mg, r_active)
        sols = [None] * len(self.levels)
        self._v_step(len(self.levels) - 1, defect[-1], defect, sols)
        return ph("to_global", self.copy_from_mg, sols, r_active)

    def _v_step(self, l: int, d_l: torch.Tensor, defect: list, sols: list) -> torch.Tensor:
        """Level l's visit; fills sols[l].  A method, not a nested closure:
        a recursive closure is a reference cycle that would keep every
        level's vectors alive until the garbage collector runs."""
        ph = self.hook
        lev = self.levels[l]
        if l == 0:
            sols[0] = ph("cs", self.coarse_solve, d_l)
            return sols[0]
        sm, tr = self.smoothers[l], self.transfers[l]
        d_smooth = d_l * lev.keep
        u = ph("pre", sm.vmult, d_smooth)
        t = ph("residuum", residual, lev, d_smooth, u)
        t = ph("edge_pro", _edge_down, lev, t, d_l, u)
        d_c = ph("res", _restrict_add, tr, defect[l - 1], t)
        u = ph("pro", prolong_add, tr, u, self._v_step(l - 1, d_c, defect, sols))
        b_eff = ph("edge_pro", _edge_up, lev, d_smooth, u)
        sols[l] = ph("post", sm.step, u, b_eff)
        return sols[l]


@dataclass(frozen=True)
class LocalSmoothingMGHybrid(_LSCycle):
    """The local-smoothing V-cycle on hybrid slot vectors: input and output
    are in the ACTIVE mesh's slot layout (api.build_level_hybrid)."""

    levels: tuple               # LSHybridLevel, coarsest first
    smoothers: tuple            # smoothers[0] unused (None)
    transfers: tuple            # ls_mode HybridTransfer; transfers[l]: l-1 -> l
    coarse_solve: object        # called as coarse_solve(b)
    n_dofs_global: int          # n_slots of the active layout
    hook: Callable = untimed

    def copy_to_mg(self, r_active: torch.Tensor) -> list:
        """copy_to_mg, zeroing each level's boundary ∪ edge rows."""
        defect = []
        for lev in self.levels:
            d = r_active.new_zeros(lev.n_dofs)
            d[lev.to_slots] = r_active[lev.to_src]
            defect.append(d * lev.keep)
        return defect

    def copy_from_mg(self, sols: list, r_active: torch.Tensor) -> torch.Tensor:
        """copy_from_mg one level at a time, coarsest first, so the finest
        level holding a dof writes it last; within a level the slots are
        unique (one scatter over all levels would leave the order of
        duplicate writes undefined on CUDA)."""
        out = r_active.new_zeros(self.n_dofs_global)
        for lev, u in zip(self.levels, sols):
            out[lev.from_slots] = u[lev.from_src]
        return out


# ---------------------------------------------------------------------------
# gather engine (2D)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LSLevel:
    """One local-smoothing level on the gather engine, global layout."""

    cell_dofs: torch.Tensor     # int64 [nc, nloc]
    cell_sum: FixedOrderSum     # cell slots -> level DoFs, in a fixed order
    scale: torch.Tensor         # [nc]
    elem: torch.Tensor          # [nloc, nloc]
    keep: torch.Tensor          # [n] 0 on boundary ∪ edge (identity rows)
    edge_ind: torch.Tensor      # [n] 1 on refinement-edge DoFs
    inv_diag: torch.Tensor
    n_dofs: int

    @property
    def dtype(self) -> torch.dtype:
        return self.keep.dtype

    @property
    def device(self) -> torch.device:
        return self.keep.device

    def cell_apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        rcell = torch.matmul(u[self.cell_dofs], self.elem) * self.scale[:, None]
        return self.cell_sum.scatter(rcell.reshape(-1))

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """Identity on boundary ∪ edge (operator.h:152-183)."""
        return self.cell_apply_raw(u * self.keep) * self.keep + u * (1.0 - self.keep)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sum(x * y)

    def interface_down(self, u: torch.Tensor) -> torch.Tensor:
        """Edge rows of the raw operator applied to an interior-supported
        function (operator.h:191-205)."""
        return self.cell_apply_raw(u * self.keep) * self.edge_ind

    def interface_up(self, u: torch.Tensor) -> torch.Tensor:
        """Interior rows of the raw operator applied to the edge part
        (operator.h:207-226)."""
        return self.cell_apply_raw(u * self.edge_ind) * self.keep


@dataclass(frozen=True)
class LSTransfer:
    """Prolongation level l-1 -> l over the refined region; restriction is
    the exact transpose with 1/valence fine weights (MGTransferMatrixFree;
    no constraints: level meshes are conforming).  Each direction assembles
    all octant buckets' outputs with one fixed-order sum."""

    buckets: tuple              # ((fine_dofs, coarse_dofs, M), ...) per octant
    fine_weight: torch.Tensor
    n_f: int
    n_c: int
    prolong_sum: FixedOrderSum
    restrict_sum: FixedOrderSum

    def prolong(self, uc: torch.Tensor) -> torch.Tensor:
        parts = [
            (torch.matmul(uc[cd], M.T) * self.fine_weight[fd]).reshape(-1)
            for fd, cd, M in self.buckets
        ]
        return self.prolong_sum.scatter(torch.cat(parts))

    def restrict(self, rf: torch.Tensor) -> torch.Tensor:
        rw = rf * self.fine_weight
        parts = [torch.matmul(rw[fd], M).reshape(-1) for fd, cd, M in self.buckets]
        return self.restrict_sum.scatter(torch.cat(parts))


@dataclass(frozen=True)
class CopyMap:
    """copy_to_mg / copy_from_mg index pairs of one level: the level DoFs
    on active cells of that level and their global active-mesh DoFs, one
    pair per DoF (so both directions write unique indices)."""

    level_idx: torch.Tensor
    global_idx: torch.Tensor


@dataclass(frozen=True)
class LocalSmoothingMG(_LSCycle):
    """The local-smoothing V-cycle as a global-vector preconditioner."""

    levels: tuple               # LSLevel, coarsest first
    smoothers: tuple            # smoothers[0] unused (None)
    transfers: tuple            # LSTransfer; transfers[l]: level l-1 -> l
    copy_maps: tuple            # CopyMap per level
    coarse_solve: object
    n_dofs_global: int
    hook: Callable = untimed

    def copy_to_mg(self, r_global: torch.Tensor) -> list:
        """Distribute the global residual onto the levels, zeroing
        constrained rows (boundary + refinement edge)."""
        defect = []
        for lev, cm in zip(self.levels, self.copy_maps):
            d = r_global.new_zeros(lev.n_dofs)
            d[cm.level_idx] = r_global[cm.global_idx]
            defect.append(d * lev.keep)
        return defect

    def copy_from_mg(self, sols: list, r_global: torch.Tensor) -> torch.Tensor:
        """Coarse-to-fine overwrite, one level at a time: each global DoF
        takes its finest level's value (interface values agree)."""
        out = r_global.new_zeros(self.n_dofs_global)
        for cm, u in zip(self.copy_maps, sols):
            out[cm.global_idx] = u[cm.level_idx]
        return out


def _octant_matrix(dim: int, degree: int, octant: int) -> np.ndarray:
    E = tensor.h_embedding_1d(degree)
    out = np.array([[1.0]])
    for d in range(dim):
        out = np.kron(E[(octant >> d) & 1], out)
    return out


def build_local_smoothing_mg(
    active_dofh: DoFHandler,
    mg_data,
    device: torch.device,
    dtype: torch.dtype,
    min_level: int = 0,
) -> LocalSmoothingMG:
    """The gather-engine LS hierarchy of the active mesh on one device.

    Order as in the JAX package's function: the levels with their copy
    maps, the octant transfers, the Chebyshev smoothers at 1.2 x the
    estimated lambda_max, the coarse solve on the coarsest level.  The
    eigenvalue start vectors come from one NumPy generator (seed 42) in
    level order, where the JAX package draws them from ``jax.random``;
    the estimates differ slightly and the 1.2 safety factor absorbs that.
    Masking the output's constrained rows (Dirichlet and hanging slaves of
    the active mesh) is the caller's job (api.PreconditionLS)."""
    active = active_dofh.mesh
    p, dim = active_dofh.degree, active.dim
    elem = element.laplace_element_matrix(dim, p)
    rng = np.random.default_rng(42)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    levels, copy_maps, meshes, dofhs = [], [], [], []
    for l in range(max(min_level, 0), active.max_level + 1):
        lm = level_mesh(active, l)
        dofh, edge, diag = level_dofs(lm, p)
        keep = np.ones(dofh.n_dofs)
        keep[dofh.boundary_mask | edge] = 0.0
        levels.append(LSLevel(
            cell_dofs=idx(dofh.cell_dofs),
            cell_sum=FixedOrderSum.build(dofh.cell_dofs, dofh.n_dofs, device),
            scale=dev(lm.h(lm.level).astype(np.float64) ** (dim - 2)),
            elem=dev(elem),
            keep=dev(keep),
            edge_ind=dev(edge.astype(np.float64)),
            inv_diag=dev(1.0 / diag),
            n_dofs=dofh.n_dofs,
        ))
        sel, pos = _copy_cells(active, lm, l)
        ld = dofh.cell_dofs[pos].reshape(-1)
        uniq_ld, first = np.unique(ld, return_index=True)
        copy_maps.append(CopyMap(idx(uniq_ld), idx(active_dofh.cell_dofs[sel].reshape(-1)[first])))
        meshes.append(lm)
        dofhs.append(dofh)

    transfers: list = [None]
    for i in range(1, len(levels)):
        lm_f, lm_c = meshes[i], meshes[i - 1]
        codes_c = morton_encode(lm_c.anchor)
        order_c = np.argsort(codes_c)
        pos = order_c[np.searchsorted(codes_c[order_c], morton_encode(lm_f.anchor >> 1))]
        bits = lm_f.anchor & 1
        octs = sum(bits[:, d] << d for d in range(dim))
        fcd, ccd = dofhs[i].cell_dofs, dofhs[i - 1].cell_dofs
        buckets = [
            (fcd[s], ccd[pos[s]], _octant_matrix(dim, p, o))
            for o in range(1 << dim)
            if len(s := np.nonzero(octs == o)[0])
        ]
        valence = np.bincount(fcd.reshape(-1), minlength=levels[i].n_dofs)
        transfers.append(LSTransfer(
            buckets=tuple((idx(fd), idx(cd), dev(M)) for fd, cd, M in buckets),
            fine_weight=dev(1.0 / np.maximum(valence, 1)),
            n_f=levels[i].n_dofs,
            n_c=levels[i - 1].n_dofs,
            prolong_sum=FixedOrderSum.build(
                np.concatenate([fd for fd, _, _ in buckets]), levels[i].n_dofs, device
            ),
            restrict_sum=FixedOrderSum.build(
                np.concatenate([cd for _, cd, _ in buckets]), levels[i - 1].n_dofs, device
            ),
        ))

    sm = mg_data.smoother
    ranges = estimate_eigenvalue_ranges(
        levels[1:],
        [lv.inv_diag for lv in levels[1:]],
        [dev(rng.standard_normal(lv.n_dofs)) for lv in levels[1:]],
        n_iterations=sm.eig_cg_n_iterations,
    )
    smoothers: list = [None]
    for lv, rg in zip(levels[1:], ranges):
        smoothers.append(ChebyshevSmoother(
            lv, lv.inv_diag, sm.degree,
            *_cheb_interval(1.2 * rg[0], sm.smoothing_range),  # deal.II safety factor
        ))
    coarse = make_algebraic_solver(
        dofhs[0], no_constraints(dofhs[0].n_dofs), dtype, device, mg_data
    )
    return LocalSmoothingMG(
        levels=tuple(levels),
        smoothers=tuple(smoothers),
        transfers=tuple(transfers),
        copy_maps=tuple(copy_maps),
        coarse_solve=coarse,
        n_dofs_global=active_dofh.n_dofs,
    )


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
