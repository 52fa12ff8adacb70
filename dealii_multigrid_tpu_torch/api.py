"""Solver assembly: build the HMG-global hierarchy and run the benchmarked solve.

Mirror of the JAX package's api.py hybrid path (reference L5 layer:
run / solve_with_global_coarsening / mg_solve, multigrid_throughput.cc:
817-2396) on torch: each level is a HybridOperator on one device, the
outer solve is a Python-loop PCG, and timings are fenced with
``torch.cuda.synchronize()``.  Solver types, number types and coarse types
that are not ported yet raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .mesh import generators
from .mesh.coarsening import geometric_coarsening_sequence
from .mesh.dof import Constraints, DoFHandler, distribute_dofs, make_hanging_node_constraints
from .mesh.octree import AdaptiveMesh
from .models import poisson
from .ops.hybrid import HybridOperator, make_hybrid_operator
from .ops.hybrid_format import HybridFormat, build_hybrid_format, cell_slot_table
from .ops.hybrid_transfer import make_hybrid_transfer
from .ops.operator import compute_diagonal
from .solvers.cg import cg_solve
from .solvers.chebyshev import ChebyshevSmoother, estimate_eigenvalue_ranges
from .solvers.coarse import make_algebraic_solver
from .solvers.multigrid import Multigrid, PreconditionMG
from .utils.device import resolve_device
from .utils.params import MultigridParameters, RunParameters

_DTYPES = {"float": torch.float32, "double": torch.float64}


def number_dtype(name: str) -> torch.dtype:
    if name in ("mixed", "df32"):
        raise NotImplementedError(
            f"number type {name!r} is not ported yet (ROADMAP item 6, mixed and df32)"
        )
    if name not in _DTYPES:
        raise ValueError(f"unknown number type {name!r}")
    return _DTYPES[name]


def gc_level_plan(
    mg_type: str, tri_sequence: list[AdaptiveMesh], degree_fine: int
) -> list[tuple[AdaptiveMesh, int]]:
    """(mesh, degree) per level, coarsest first (reference:
    multigrid_throughput.cc:1546-1576).  HMG-global: every mesh of the
    geometric coarsening sequence at the fine degree."""
    if mg_type in ("PMG", "HPMG"):
        raise NotImplementedError(
            f"{mg_type} is not ported yet (ROADMAP item 7, PMG/HPMG p-transfers)"
        )
    if mg_type != "HMG-global":
        raise ValueError(f"unknown global-coarsening type {mg_type!r}")
    return [(t, degree_fine) for t in tri_sequence]


@dataclass
class HybridLevel:
    mesh: AdaptiveMesh
    degree: int
    dofh: DoFHandler
    hanging: Constraints
    fmt: HybridFormat
    op: HybridOperator
    inv_diag: torch.Tensor          # slot layout
    eig_b0: torch.Tensor            # consistent random vector for eig estimation
    from_global_idx: torch.Tensor   # [n_slots] dof per slot (sentinel n_dofs)
    to_global_idx: torch.Tensor     # [n_dofs] representative slot per dof

    def to_global(self, flat: torch.Tensor) -> torch.Tensor:
        return flat[self.to_global_idx]


def build_level_hybrid(
    mesh: AdaptiveMesh, degree: int, device: torch.device, dtype: torch.dtype,
    K: int = 8,
) -> HybridLevel:
    dofh = distribute_dofs(mesh, degree)
    hanging = make_hanging_node_constraints(dofh)
    fmt = build_hybrid_format(dofh, K=K)
    op = make_hybrid_operator(fmt, hanging, device, dtype)
    diag = compute_diagonal(dofh, hanging)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    # the reference draws the eigenvalue start vector the same way (seed 42)
    rng = np.random.default_rng(42)
    return HybridLevel(
        mesh=mesh,
        degree=degree,
        dofh=dofh,
        hanging=hanging,
        fmt=fmt,
        op=op,
        inv_diag=dev(fmt.from_global(1.0 / diag)),
        eig_b0=dev(fmt.from_global(rng.standard_normal(dofh.n_dofs))),
        from_global_idx=torch.as_tensor(fmt.slot_dof, dtype=torch.int64, device=device),
        to_global_idx=torch.as_tensor(fmt.rep_slot, dtype=torch.int64, device=device),
    )


def build_gc_preconditioner_hybrid(
    levels: list[HybridLevel], mg_data: MultigridParameters
) -> Multigrid:
    kind = mg_data.coarse_solver.type
    if kind not in ("amg", "direct"):
        raise NotImplementedError(
            f"coarse solver type {kind!r} is not ported yet (ROADMAP item 10, AMG "
            "and the other coarse types)"
        )
    transfers: list = [None]
    for l in range(1, len(levels)):
        transfers.append(
            make_hybrid_transfer(
                levels[l].fmt, levels[l - 1].fmt, levels[l].op, levels[l - 1].op
            )
        )
    # every level is estimated exactly (no extrapolation of the fine levels)
    ranges = estimate_eigenvalue_ranges(
        [lv.op for lv in levels[1:]],
        [lv.inv_diag for lv in levels[1:]],
        [lv.eig_b0 for lv in levels[1:]],
        n_iterations=mg_data.smoother.eig_cg_n_iterations,
        use_op_dot=True,
    )
    smoothers: list = [None]
    for l in range(1, len(levels)):
        smoothers.append(
            ChebyshevSmoother.create(
                levels[l].op,
                levels[l].inv_diag,
                max_eigenvalue=1.2 * ranges[l - 1][0],  # deal.II safety factor
                degree=mg_data.smoother.degree,
                smoothing_range=mg_data.smoother.smoothing_range,
            )
        )
    coarse = make_algebraic_solver(
        levels[0].dofh, levels[0].hanging,
        levels[0].to_global_idx, levels[0].from_global_idx, levels[0].op.dtype,
    )
    return Multigrid(
        operators=tuple(lv.op for lv in levels),
        smoothers=tuple(smoothers),
        transfers=tuple(transfers),
        coarse_solve=coarse,
    )


@dataclass
class MGSolveResult:
    x: torch.Tensor
    n_iterations: int
    converged: bool
    time: float                 # best of n_repetitions, seconds
    time_per_rep: list
    throughput: float           # n_dofs * n_iterations / time (DoF/s)
    n_dofs: int
    n_levels: int
    residual_norm: float        # the CG loop's final residual
    true_residual: float        # ||b - A x|| recomputed after the solve
    guard_threshold: float      # the allowance the true residual passed
    solve_iterations: list      # iteration count of every solve, warm-up first
    setup_time: float = 0.0     # host + device setup before the first solve, s
    mg: Multigrid | None = None
    rhs_used: torch.Tensor | None = None


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mg_solve(
    fine_op: HybridOperator,
    rhs: torch.Tensor,
    preconditioner,
    mg_data: MultigridParameters,
    n_levels: int,
    n_dofs: int,
) -> MGSolveResult:
    """Warm-up solve + best-of-n_repetitions timed CG, the reference's
    benchmark protocol (multigrid_throughput.cc:1140-1268)."""
    ctrl = mg_data.cg_parameter_study if mg_data.do_parameter_study else mg_data.cg_normal
    force = mg_data.cg_parameter_study.maxiter if mg_data.do_parameter_study else None
    device = rhs.device

    def solve():
        return cg_solve(
            fine_op.vmult, rhs, preconditioner=preconditioner.vmult,
            maxiter=ctrl.maxiter, abstol=ctrl.abstol, reltol=ctrl.reltol,
            force_iterations=force, dot=fine_op.dot,
        )

    res = solve()  # warm-up
    _fence(device)
    iterations = [res.n_iterations]
    times = []
    for _ in range(mg_data.n_repetitions):
        t0 = time.perf_counter()
        res = solve()
        _fence(device)
        times.append(time.perf_counter() - t0)
        iterations.append(res.n_iterations)
    best = min(times)

    # correctness guard: recompute ||b - A x|| outside the timed loop and
    # require agreement with the loop's residual, allowing for the floor the
    # operator's precision puts under the attainable true residual
    r = rhs - fine_op.vmult(res.x)
    true_res = float(torch.sqrt(fine_op.dot(r, r)))
    eps_op = torch.finfo(fine_op.dtype).eps
    floor = 1e4 * eps_op * res.norm0
    tol_abs = max(ctrl.abstol, ctrl.reltol * res.norm0)
    threshold = 10.0 * max(tol_abs, res.residual_norm) + floor
    if not mg_data.do_parameter_study and not true_res <= threshold:
        raise RuntimeError(
            "the port's CG residual disagrees with the recomputed residual "
            f"||b - A x|| (loop {res.residual_norm:.3e} vs true {true_res:.3e}, "
            f"||b|| {res.norm0:.3e}, allowance {threshold:.3e}): the operator, "
            "preconditioner or a kernel computed an inconsistent state"
        )
    return MGSolveResult(
        x=res.x,
        n_iterations=res.n_iterations,
        converged=bool(res.converged),
        time=best,
        time_per_rep=times,
        throughput=n_dofs * res.n_iterations / best if best > 0 else 0.0,
        n_dofs=n_dofs,
        n_levels=n_levels,
        residual_norm=res.residual_norm,
        true_residual=true_res,
        guard_threshold=threshold,
        solve_iterations=iterations,
    )


def solve_with_global_coarsening_hybrid(
    params: RunParameters, fine_mesh: AdaptiveMesh, device: torch.device
):
    """HMG-global solve on the hybrid engine, one device.  Returns
    (result, problem, levels)."""
    if params.n_shards not in (0, 1):
        raise NotImplementedError(
            "sharded solves are not ported yet (ROADMAP item 13, multi-device)"
        )
    t_setup = time.perf_counter()
    outer_dtype = number_dtype(params.number_type)
    level_dtype = number_dtype(params.mg_number_type)
    tri_seq = geometric_coarsening_sequence(
        fine_mesh, params.min_level, params.min_n_cells
    )
    plan = gc_level_plan(params.type, tri_seq, params.fe_degree_fine)
    levels = [
        build_level_hybrid(mesh, degree, device, level_dtype) for mesh, degree in plan
    ]
    fine = levels[-1]
    outer_op = (
        fine.op
        if outer_dtype == level_dtype
        else make_hybrid_operator(fine.fmt, fine.hanging, device, outer_dtype)
    )
    problem, rhs_slots = poisson.assemble_problem_hybrid(
        fine.dofh, fine.hanging, outer_op, cell_slot_table(fine.fmt), fine.fmt,
        params.simulation_type,
    )
    mg = build_gc_preconditioner_hybrid(levels, params.mg_data)
    _fence(device)
    setup_time = time.perf_counter() - t_setup
    result = mg_solve(
        outer_op,
        rhs_slots,
        PreconditionMG(mg, outer_dtype),
        params.mg_data,
        n_levels=len(levels),
        n_dofs=fine.dofh.n_dofs,
    )
    result.setup_time = setup_time
    result.mg = mg
    result.rhs_used = rhs_slots
    # back to the global layout for error evaluation
    result.x = fine.to_global(result.x)
    return result, problem, levels


def run(params: RunParameters, device: str | torch.device | None = None):
    """Reference run<dim, ...>() equivalent: build the mesh, dispatch the
    solver (multigrid_throughput.cc:2019-2396)."""
    device = resolve_device(device)
    mesh = generators.create(
        params.geometry_type, params.dim, params.n_ref_global, params.n_ref_local
    )
    return dispatch_solve(params, mesh, device)


def dispatch_solve(params: RunParameters, mesh: AdaptiveMesh, device: torch.device):
    """The reference's solver-type switch (multigrid_throughput.cc:2337-2353)."""
    if params.dim != 3:
        raise NotImplementedError(
            "2D runs on the gather engine, not ported yet (ROADMAP item 11)"
        )
    if params.type == "HMG-global":
        # float32 contractions must stay full precision: TF32 raised CG from 3
        # to 9 iterations on the reference (ops/hybrid.py:44-47 there)
        torch.backends.cuda.matmul.allow_tf32 = False
        return solve_with_global_coarsening_hybrid(params, mesh, device)
    items = {
        "PMG": "7, PMG/HPMG p-transfers",
        "HPMG": "7, PMG/HPMG p-transfers",
        "HMG-local": "8, local smoothing",
        "HPMG-local": "8, local smoothing",
        "AMG": "10, AMG",
        "AMGPETSc": "10, AMG",
    }
    if params.type in items:
        raise NotImplementedError(
            f"solver type {params.type!r} is not ported yet (ROADMAP item "
            f"{items[params.type]})"
        )
    raise ValueError(f"unknown solver type {params.type!r}")
