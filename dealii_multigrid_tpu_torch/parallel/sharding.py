"""Distribution layer: domain-decompose the multigrid levels over ranks.

The JAX package shards its arrays over a device mesh and lets XLA's SPMD
partitioner place the halo collectives (dealii_multigrid_tpu/parallel/
sharding.py).  The port runs one process per rank under ``torch.distributed``
(parallel/launch.py) and cuts every level down to the rank's part:

  * the device-major hybrid layout (ops/hybrid_format.repartition_format)
    puts whole patches on ranks: equal Morton patch blocks by default (the
    p4est DefaultPolicy analog), or a repartitioning policy's cell map;
  * a level with too few cells (fewer than ``grain_size`` per rank) is
    replicated: every rank holds and computes all of it, the analog of the
    reference's shrinking coarse sub-communicators without idle ranks;
  * each sharded level's operator and transfers apply on the rank's span,
    with ghost imports planned on the host (ops/hybrid_rank.py,
    parallel/comm.py);
  * an algebraic coarse solve on a sharded level gathers the right-hand
    side, solves it on every rank identically and keeps the rank's span.

Every rank builds the whole hierarchy's host tables and cuts its part; no
table is sent between ranks.  The gather engine shards over Morton cell
blocks (``shard_level_arrays``): the rank owns a block of DoFs and applies
the cells that touch them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fixed_order import FixedOrderSum
from ..solvers.vcycle_graph import comm_reason, reason_of
from ..utils.phases import KEYS, hook_field
from .comm import Comm, ExtIndex, SlotPart, current_comm


def hybrid_level_shard_count(n_cells: int, n_devices: int, grain_size: int = 8) -> int:
    """Per-level shard count: shard over all ranks while each keeps at least
    ``grain_size`` cells, else replicate (the BalancedGranularity rule,
    reference multigrid_throughput.cc:370-420, in the two-tier
    sharded/replicated form of the JAX package)."""
    return n_devices if n_cells >= grain_size * n_devices else 1


def default_cell_shard_map(fmt, n_cells: int) -> np.ndarray:
    """The cell->rank map a device-major HybridFormat applies (its patch and
    singleton index blocks), for the MG statistics of a run that used no
    explicit policy."""
    D = fmt.n_shards
    out = np.zeros(n_cells, np.int32)
    if D <= 1:
        return out
    NPp = len(fmt.patch_level)
    if NPp:
        pps = NPp // D
        pc = np.asarray(fmt.patch_cells)
        if pc.ndim == 1:
            pc = pc[:, None]
        shard = (np.arange(NPp) // pps).astype(np.int32)
        valid = pc >= 0
        out[pc[valid]] = np.repeat(shard, pc.shape[1])[valid.ravel()]
    sc = np.asarray(fmt.single_cells)
    NSp = len(sc)
    if NSp:
        sps = NSp // D
        ok = sc >= 0
        out[sc[ok]] = ((np.arange(NSp) // sps).astype(np.int32))[ok]
    return out


def level_partitions(plan, n_devices: int, policy_name: str = "") -> list:
    """Per level of a GC plan: (shard count, cell->rank map or None for the
    default index blocks), by the JAX package's rule: a policy's partition
    where the level has at least ``n_devices`` cells and the partition uses
    more than one rank, else the granularity rule."""
    from . import partition as PT

    parts = None
    if policy_name:
        meshes = [m for m, _ in plan]
        fine_dofh = None
        if policy_name.startswith("CellWeightPolicy"):
            from ..mesh.dof import distribute_dofs

            fine_dofh = distribute_dofs(meshes[-1], plan[-1][1])
        parts = PT.partition_hierarchy(policy_name, meshes, n_devices, fine_dofh)
    out = []
    for li, (mesh0, _degree) in enumerate(plan):
        if parts is not None and mesh0.n_cells >= n_devices:
            part = np.asarray(parts[li])
            if int(part.max()) + 1 > 1:
                out.append((n_devices, part))
            else:
                out.append((1, None))
        else:
            out.append((hybrid_level_shard_count(mesh0.n_cells, n_devices), None))
    return out


def build_sharded_hybrid_levels(plan, level_dtype, device, n_devices: int,
                                policy_name: str = ""):
    """This rank's hybrid levels of a GC plan, each sharded or replicated
    (``level_partitions``).  Returns (levels, partitions): the partitions
    actually applied (None for replicated levels), as the JAX package's
    function of this name returns them."""
    from .. import api

    levels, applied = [], []
    for (mesh0, degree), (D, cell_shard) in zip(plan, level_partitions(plan, n_devices, policy_name)):
        lv = api.build_level_hybrid(
            mesh0, degree, device, level_dtype, n_shards=D, cell_shard=cell_shard
        )
        levels.append(lv)
        if cell_shard is None and D > 1:
            cell_shard = default_cell_shard_map(lv.fmt, mesh0.n_cells)
        applied.append(cell_shard)
    return levels, applied


@dataclass(frozen=True)
class GatheredSolve:
    """A coarse solve on a sharded level run on every rank: gather the
    right-hand side (every rank's span), solve the whole level identically
    everywhere, keep the rank's span."""

    inner: object
    op: object

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.op.own(self.inner.vmult(self.op.gather(b)))

    vmult = __call__

    def graph_reason(self) -> str | None:
        return reason_of(self.inner) or comm_reason(self.op)

    def with_hook(self, hook, phases: tuple = KEYS) -> "GatheredSolve":
        return hook_field(self, "inner", hook, phases)


def rank_copies(h, active_fmt, device) -> dict:
    """The two copies of a local-smoothing level (copy_to_mg: level slots
    from the active layout's representatives; copy_from_mg: active slots
    from the level's representatives) on this rank: its own targets, and
    sources on other ranks through one import each."""
    comm = current_comm()
    pl = SlotPart.of(h.fmt, comm.rank)
    pa = SlotPart.of(active_fmt, comm.rank)
    out = {}
    sel = pl.own(h.to_slots)
    ix = ExtIndex(pa)
    ix.add(h.to_src[sel])
    em = ix.finish(comm if pa.sharded else None, device)
    out.update(to_slots=h.to_slots[sel] - pl.lo, to_src=em(h.to_src[sel]), to_ext=em)
    sel = pa.own(h.from_slots)
    ix = ExtIndex(pl)
    ix.add(h.from_src[sel])
    em = ix.finish(comm if pl.sharded else None, device)
    out.update(from_slots=h.from_slots[sel] - pa.lo, from_src=em(h.from_src[sel]), from_ext=em)
    return out


def operator_imports(op) -> list:
    """The ghost imports of one vmult of a rank operator, stage by stage."""
    imps = []
    if op.c_node is not None:
        imps.append(op.c_node[0].imp)
    imps += [em.imp for em, _p, _w in op.c_rounds_r]
    imps += [em.imp for em, _p, _s in op.ct_rounds_r]
    if op.irr_r is not None:
        imps.append(op.irr_r[0].imp)
    imps += [step["imp"] for step in op.axes_r]
    if op.ct_node is not None:
        imps.append(op.ct_node[0].imp)
        if op.ct_node[5] is not None:
            imps.append(op.ct_node[5][0].imp)
    return imps


def operator_ghosts(op) -> int:
    """Slot values one vmult of a rank operator imports (all its stages)."""
    return sum(imp.n_ghost for imp in operator_imports(op))


# ---------------------------------------------------------------------------
# the gather engine over Morton cell blocks
# ---------------------------------------------------------------------------


def pad_level_for_sharding(n_cells: int, n_dofs: int, n_shards: int) -> tuple[int, int]:
    """Cell batch and vector lengths rounded up to multiples of the shard
    count (the JAX package pads its arrays; here the padded DoFs are the
    empty tail of the last rank's block)."""
    def up(n, m):
        return -(-n // m) * m

    return up(n_cells, n_shards), up(n_dofs, n_shards)


class RankLaplaceOperator:
    """The gather-engine Laplacian (ops/operator.py) on one rank's block of
    ``n_dofs_padded / D`` DoFs: the rank applies the cells that touch its
    DoFs (a surface layer of them is applied on two ranks), importing the
    values of their other DoFs, then C^T from the slaves of its masters.
    Vectors are the rank's block; the padded tail has no cells and maps
    to zero, as the JAX package's padding does."""

    def __init__(self, dofh, hanging, device, dtype, comm: Comm | None = None):
        from ..ops import element
        from ..ops.operator import split_boundary_constraints

        comm = comm or current_comm()
        self.comm, self.device, self.dtype = comm, torch.device(device), dtype
        D, r = comm.world, comm.rank
        _, nd = pad_level_for_sharding(dofh.mesh.n_cells, dofh.n_dofs, D)
        blk = nd // D
        self.n_dofs = blk
        part = SlotPart(D, r, nd, blk, 1, 1, 0, 0)
        self.part = part
        lo = part.lo
        mesh, dim, p = dofh.mesh, dofh.dim, dofh.degree
        hang, dirichlet = split_boundary_constraints(dofh, hanging)
        scale = mesh.h(mesh.level).astype(np.float64) ** (dim - 2)
        cd = dofh.cell_dofs.astype(np.int64)

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def val(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

        keep = np.ones(nd)
        keep[dirichlet] = 0.0
        constrained = np.zeros(nd, bool)
        constrained[dirichlet] = True
        constrained[hang.slave] = True
        self.dkeep = val(part.slice(keep))
        self.ckeep = val(part.slice((~constrained).astype(np.float64)))
        # C: own slaves from their masters
        s_sel = part.own(hang.slave)
        ix = ExtIndex(part)
        ix.add(hang.masters[s_sel])
        em = ix.finish(comm, device)
        self.c = (em, idx(hang.slave[s_sel] - lo), idx(em(hang.masters[s_sel])),
                  val(hang.weights[s_sel]))
        # cells touching own DoFs; their DoFs after C
        cells = np.nonzero(part.own(cd).any(1))[0]
        ix = ExtIndex(part)
        ix.add(cd[cells])
        em = ix.finish(comm, device)
        tgt = cd[cells].reshape(-1)
        self.cells = (em, idx(em(cd[cells])), val(scale[cells]),
                      val(element.laplace_element_matrix(dim, p)),
                      FixedOrderSum.build(np.where(part.own(tgt), tgt - lo, -1), blk, device))
        # C^T: own masters gather w * r[slave] (slaves may be remote)
        w = hang.weights
        si, ki = np.nonzero(w != 0) if w.size else (np.zeros(0, int), np.zeros(0, int))
        m = hang.masters[si, ki] if w.size else np.zeros(0, np.int64)
        e = part.own(m)
        ix = ExtIndex(part)
        ix.add(hang.slave[si[e]])
        em = ix.finish(comm, device)
        self.ct = (em, idx(em(hang.slave[si[e]])), val(w[si[e], ki[e]]),
                   FixedOrderSum.build(m[e] - lo, blk, device))
        self.slave_keep = val(part.slice(np.where(np.isin(np.arange(nd), hang.slave), 0.0, 1.0)))

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        u0 = u
        u = u * self.dkeep
        em, slaves, masters, w = self.c
        ue = em.extend(u)
        if slaves.shape[0]:
            u = u.clone()
            u[slaves] = (w * ue[masters]).sum(-1)
        em, cdofs, scale, elem, csum = self.cells
        rcell = torch.matmul(em.extend(u)[cdofs], elem) * scale[:, None]
        r = csum.scatter(rcell.reshape(-1))
        em, sl, wv, msum = self.ct
        vals = wv * em.extend(r)[sl]
        r = r * self.slave_keep
        msum.add_into(r, vals)
        r = r * self.dkeep
        return r * self.ckeep + u0 * (1.0 - self.ckeep)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.comm.allsum(torch.sum(x * y).reshape(1))[0]


def shard_level_arrays(dofh, hanging, device, dtype) -> RankLaplaceOperator:
    """The rank's part of a gather-engine level (the JAX package places the
    padded cell and vector arrays on a device mesh; here the rank keeps its
    DoF block and the cells that touch it)."""
    return RankLaplaceOperator(dofh, hanging, device, dtype)


# ---------------------------------------------------------------------------
# the rank entry point of launched test and smoke runs
# ---------------------------------------------------------------------------


def run_cases(cases: list, device: torch.device) -> list | None:
    """Run each case on this rank (parallel/launch.py calls it on every
    rank); rank 0 returns one dict per case.  A case is a dict:

      * ``{"params": RunParameters}``: the solve through ``api.run`` under
        the group, with ``n_shards`` the world size.  Rank 0 gets x (global
        DoF layout, float64 NumPy), the iteration counts, the guard, the
        partitions, and per rank its stencil launches, peak memory, set-up
        seconds, and per level (coarsest first) its patch shapes and its
        owned and ghost slots.  Options: ``"coarse_probe"``: one more
        V-cycle whose coarse-solve input and output are compared bit for
        bit over the ranks (``coarse_equal``); ``"repeat"``: that many more
        solves with the same hierarchy, their x compared bit for bit with
        the first (``repeat_equal``); ``"fault"``: that rank raises inside
        its first V-cycle.
      * ``{"gather_cg": (geometry, n_ref, degree, seed)}``: CG on the
        gather-engine Laplacian sharded over Morton cell blocks
        (``shard_level_arrays``), x in the global layout.
    """
    import torch.distributed as dist

    rank = dist.get_rank()
    out = []
    for case in cases:
        if "gather_cg" in case:
            res = _gather_cg_case(case["gather_cg"], device)
        else:
            res = _solve_case(case, device)
        out.append(res)
    return out if rank == 0 else None


def _gather_cg_case(spec, device):
    from ..mesh import generators
    from ..mesh.dof import distribute_dofs, make_hanging_node_constraints
    from ..solvers.cg import cg_solve

    geo, r, p, seed = spec
    dofh = distribute_dofs(generators.create(geo, 3, r), p)
    hanging = make_hanging_node_constraints(dofh)
    op = shard_level_arrays(dofh, hanging, device, torch.float64)
    rng = np.random.default_rng(seed)
    b = np.zeros(op.part.n_slots)
    b[: dofh.n_dofs] = rng.normal(size=dofh.n_dofs)
    from ..ops.operator import split_boundary_constraints

    hang, dirichlet = split_boundary_constraints(dofh, hanging)
    b[np.concatenate([dirichlet, hang.slave]).astype(np.int64)] = 0.0
    bt = torch.as_tensor(op.part.slice(b), dtype=torch.float64, device=device)
    res = cg_solve(op.vmult, bt, maxiter=20, reltol=1e-6, dot=op.dot)
    x = op.comm.all_gather(res.x).reshape(-1)[: dofh.n_dofs]
    return {"x": x.cpu().numpy(), "n_iterations": res.n_iterations, "b": b[: dofh.n_dofs]}


def _solve_case(case, device):
    import dataclasses
    import time

    import torch.distributed as dist

    from .. import api
    from ..mesh import generators
    from ..ops import patch_stencil as ps
    from ..solvers import multigrid as MG

    params = case["params"]
    rank, world = dist.get_rank(), dist.get_world_size()
    params = dataclasses.replace(params, n_shards=world)
    mesh = generators.create(
        params.geometry_type, params.dim, params.n_ref_global, params.n_ref_local
    )
    fault = case.get("fault")
    orig = MG.Multigrid._v_cycle
    if fault is not None and fault == rank:
        def failing(self, level, b):
            raise RuntimeError(f"injected fault on rank {rank} inside a V-cycle")

        MG.Multigrid._v_cycle = failing
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ps.launches.reset()
    t0 = time.perf_counter()
    try:
        result, _problem, levels = api.dispatch_solve(params, mesh, device)
    finally:
        MG.Multigrid._v_cycle = orig
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = ps.launches.count
    wall = time.perf_counter() - t0
    ops = _path_ops(result, levels)
    mine = {
        "rank": rank,
        "device": str(device),
        "backend": str(dist.get_backend()),
        "solve_iterations": list(result.solve_iterations),
        "launches": launches,
        "seconds": wall,
        "setup_time": result.setup_time,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
        "levels": [_op_info(op) for op in ops],
    }
    res = {}
    if case.get("coarse_probe"):
        res["coarse_equal"] = _coarse_probe(result, levels, device)
    if case.get("repeat"):
        res["repeat_equal"] = _repeat_probe(result, levels, params, case["repeat"])
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    res.update(
        x=result.x.double().cpu().numpy(),
        n_iterations=result.n_iterations,
        solve_iterations=list(result.solve_iterations),
        converged=result.converged,
        true_residual=result.true_residual,
        guard_threshold=result.guard_threshold,
        n_shards=result.n_shards,
        sub_comm_size=result.sub_comm_size,
        partitions=result.partitions,
        ranks=ranks,
    )
    return res


def _path_ops(result, levels) -> list:
    """The hybrid operators of a solve path, coarsest first: the GC levels,
    or the LS levels then HPMG-local's p-levels."""
    if result.ls_mg is not None:
        ops = [lv.op for lv in result.ls_mg.levels]
        if result.mg is not None:
            ops += list(result.mg.operators[1:])
        return ops
    return [lv.op for lv in levels]


def _op_info(op) -> dict:
    part = getattr(op, "part", None)
    return {
        "NP": int(op.NP), "S": int(op.S), "band": int(op.band),
        "dtype": str(op.dtype).replace("torch.", ""),
        "n_shards": 1 if part is None else part.shards,
        "owned": int(op.n_slots),
        "ghosts": 0 if part is None else operator_ghosts(op),
        "KS": op.KS.double().cpu(), "MS": op.MS.double().cpu(),
        "pscale": op.pscale.double().cpu(),
    }


def _coarse_probe(result, levels, device) -> bool:
    """One more V-cycle (the LS hierarchy's where there is one) on a random
    right-hand side; the coarsest level's input and output on this rank
    against every other rank's, bit for bit (the coarsest level must be
    replicated)."""
    import dataclasses

    comm = current_comm()
    mg = result.ls_mg if result.ls_mg is not None else result.mg
    assert mg.levels[0].fmt.n_shards == 1 if result.ls_mg is not None else (
        levels[0].fmt.n_shards == 1), "the coarsest level is sharded"
    seen = {}

    def hook(phase, level, fn, *args):
        out = fn(*args)
        if phase == "cs":
            seen["in"], seen["out"] = args[0].clone(), out.clone()
        return out

    n = mg.n_dofs_global if result.ls_mg is not None else levels[-1].op.n_slots
    gen = torch.Generator().manual_seed(7 + comm.rank)
    b = torch.randn(n, generator=gen, dtype=torch.float64).to(device, levels[-1].op.dtype)
    dataclasses.replace(mg, hook=hook).vmult(b)
    ok = True
    for t in (seen["in"], seen["out"]):
        all_t = comm.all_gather(t)
        ok &= bool((all_t == all_t[0]).all())
    return ok


def _repeat_probe(result, levels, params, n: int) -> bool:
    """``n`` more solves with the hierarchy of ``result``; each x (global
    layout) bit for bit equal to the first solve's (on every rank; the
    answer is every rank's at once)."""
    import dataclasses

    from .. import api
    from ..solvers.multigrid import PreconditionMG

    fine = levels[-1]
    precond = PreconditionMG(result.mg, fine.op.dtype)
    data = dataclasses.replace(params.mg_data, n_repetitions=1)
    ok = True
    for _ in range(n):
        r = api.mg_solve(fine.op, result.rhs_used, precond, data, len(levels), fine.dofh.n_dofs)
        ok &= bool(torch.equal(fine.to_global(r.x), result.x))
    flags = current_comm().all_gather(
        torch.tensor([1.0 if ok else 0.0], dtype=torch.float64, device=fine.op.device)
    )
    return bool((flags == 1).all())


# ---------------------------------------------------------------------------
# the JAX package's dryruns
# ---------------------------------------------------------------------------


def _dryrun_params(mg_type: str, n_ref: int, degree: int, reltol: float, policy: str = ""):
    from ..utils.params import RunParameters

    p = RunParameters()
    p.type = mg_type
    p.geometry_type = "quadrant"
    p.n_ref_global = n_ref
    p.fe_degree_fine = degree
    p.number_type = p.mg_number_type = "double"
    p.mg_data.coarse_solver.type = "amg"
    p.mg_data.smoother.degree = 3
    p.mg_data.cg_normal.reltol = reltol
    p.mg_data.n_repetitions = 1
    p.policy_name = policy
    if mg_type == "HMG-global":
        p.simulation_type = "Gaussian"
    return p


def dryrun(cases: list, n_devices: int, device: str = "cuda") -> list:
    """Each case over ``n_devices`` ranks (one launch for all) and on one
    rank: [(params, relative 2-norm difference of x, sharded iterations,
    one-rank iterations)], each held to the JAX package's bound (1e-8,
    +-1)."""
    from .. import api
    from .launch import launch

    out = launch("dealii_multigrid_tpu_torch.parallel.sharding:run_cases",
                 [{"params": p} for p in cases], n_devices, device)
    rows = []
    for p, got in zip(cases, out):
        ref, _, _ = api.run(p, "cpu" if device == "cpu" else "cuda:0")
        x1 = ref.x.double().cpu().numpy()
        rel = float(np.linalg.norm(got["x"] - x1) / max(np.linalg.norm(x1), 1e-300))
        assert rel < 1e-8, f"sharded {p.type} ({p.policy_name!r}) diverged: {rel:e}"
        assert abs(got["n_iterations"] - ref.n_iterations) <= 1, (got["n_iterations"], ref.n_iterations)
        rows.append((p, rel, got["n_iterations"], ref.n_iterations))
    return rows


def dryrun_configurations(n_ref: int = 5, degree: int = 3, reltol: float = 1e-10) -> list:
    """The JAX package's dryrun configurations: HMG-global with the Morton
    default partition and with CellWeightPolicy-2.0 (Gaussian right-hand
    side), then HMG-local with per-level-mesh partitions; float64, coarse
    amg."""
    return [_dryrun_params("HMG-global", n_ref, degree, reltol, policy)
            for policy in ("", "CellWeightPolicy-2.0")] + [
        _dryrun_params("HMG-local", n_ref, degree, reltol)]


def dryrun_sharded_solve(n_devices: int, n_ref: int = 5, degree: int = 3,
                         reltol: float = 1e-10, device: str = "cuda") -> list:
    """HMG-global over ``n_devices`` ranks with both partitions, each
    asserted equal to the one-rank solve (the JAX package's
    dryrun_sharded_solve); the rows of ``dryrun``."""
    return dryrun(dryrun_configurations(n_ref, degree, reltol)[:2], n_devices, device)


def dryrun_sharded_ls_solve(n_devices: int, n_ref: int = 5, degree: int = 3,
                            reltol: float = 1e-10, device: str = "cuda") -> list:
    """HMG-local with per-level-mesh partitions over ``n_devices`` ranks,
    asserted equal to the one-rank solve (the JAX package's
    dryrun_sharded_ls_solve); the rows of ``dryrun``."""
    return dryrun(dryrun_configurations(n_ref, degree, reltol)[2:], n_devices, device)
