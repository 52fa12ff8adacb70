"""Solver assembly: build the multigrid hierarchy and run the benchmarked solve.

Mirror of the JAX package's api.py (reference L5 layer: run /
solve_with_global_coarsening / solve_with_local_smoothing / solve_with_amg /
mg_solve, multigrid_throughput.cc:817-2396) on torch.  In 3D each level of
an HMG-global, PMG, HPMG, HMG-local or HPMG-local hierarchy is a
HybridOperator on one device; in 2D the same five types run on the gather
engine (LaplaceOperator levels, ops/transfer.py, the gather-engine local
smoothing), as in the JAX package.  Any of the reference's coarse-solver
types sits below; AMG and AMGPETSc precondition the gather-engine operator
with the algebraic solver alone.  The outer solve is a Python-loop PCG in
float, double, mixed (float64 vectors around float32 levels) or df32
(double-single float32 pairs, solvers/twofloat.py, hybrid engine only),
and timings are fenced with ``torch.cuda.synchronize()``.  What is not
ported yet (bfloat16 levels, sharded solves) raises NotImplementedError
naming its ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .mesh import generators
from .mesh.coarsening import geometric_coarsening_sequence, polynomial_coarsening_sequence
from .mesh.dof import Constraints, DoFHandler, distribute_dofs, make_hanging_node_constraints
from .mesh.octree import AdaptiveMesh
from .models import poisson
from .ops.hybrid import HybridOperator, make_hybrid_operator
from .ops.hybrid_format import HybridFormat, build_hybrid_format, cell_slot_table
from .ops.hybrid_transfer import make_hybrid_transfer
from .ops.operator import LaplaceOperator, compute_diagonal, make_operator
from .ops.transfer import make_two_level_transfer
from .solvers.cg import cg_solve
from .solvers.chebyshev import (
    ChebyshevSmoother,
    estimate_eigenvalue_range,
    estimate_eigenvalue_ranges,
)
from .solvers.coarse import make_algebraic_solver, make_cg_coarse_solver, make_coarse_solver
from .solvers import twofloat
from .solvers.local_smoothing import (
    LocalSmoothingMG,
    LocalSmoothingMGHybrid,
    build_local_smoothing_mg,
    build_local_smoothing_mg_hybrid,
)
from .solvers.multigrid import Multigrid, PreconditionMG
from .utils.device import resolve_device
from .utils.params import MultigridParameters, RunParameters
from .utils.phases import PhaseRecorder, instrument

_DTYPES = {
    "float": torch.float32,
    "double": torch.float64,
    # float64 Krylov vectors and dots around the float32 operator
    "mixed": torch.float64,
    # double-single float32 pairs (solvers/twofloat.py); vectors round to
    # float32 at the API surface
    "df32": torch.float32,
}


def number_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        raise NotImplementedError(
            "number type 'bfloat16' is not ported yet (ROADMAP item 6, bfloat16 levels)"
        )
    if name not in _DTYPES:
        raise ValueError(f"unknown number type {name!r}")
    return _DTYPES[name]


class MixedPrecisionOperator:
    """float64-in/float64-out wrapper applying the operator in its own
    (float32) precision; dots run in float64."""

    dtype = torch.float64

    def __init__(self, op: HybridOperator):
        self.op = op
        # the ownership mask, cast once (a dot casts it to x's dtype)
        self.owner = op.owner.to(torch.float64)

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        return self.op.vmult(x.to(self.op.dtype)).to(torch.float64)

    def dot(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.sum(x * self.owner.to(x.dtype) * y)


@dataclass
class LevelContext:
    """One level of the gather engine: mesh + degree + operator + smoother data."""

    mesh: AdaptiveMesh
    degree: int
    dofh: DoFHandler
    hanging: Constraints
    op: LaplaceOperator
    inv_diag: torch.Tensor


def build_level(
    mesh: AdaptiveMesh, degree: int, device: torch.device, dtype: torch.dtype
) -> LevelContext:
    dofh = distribute_dofs(mesh, degree)
    hanging = make_hanging_node_constraints(dofh)
    op = make_operator(dofh, hanging, device, dtype)
    inv_diag = torch.as_tensor(
        1.0 / compute_diagonal(dofh, hanging), dtype=dtype, device=device
    )
    return LevelContext(mesh, degree, dofh, hanging, op, inv_diag)


def level_in(level: LevelContext, dtype: torch.dtype) -> LevelContext:
    """The same level with its operator in ``dtype`` (the host DoFs and
    constraints are reused)."""
    if level.op.dtype == dtype:
        return level
    op = make_operator(level.dofh, level.hanging, level.op.device, dtype)
    return LevelContext(
        level.mesh, level.degree, level.dofh, level.hanging, op, level.inv_diag.to(dtype)
    )


def _seeded_normal(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The eigenvalue-estimation start vector of a gather-engine level: the
    JAX package draws it from ``jax.random``, the port from NumPy (seed 42),
    as on its hybrid levels."""
    return torch.as_tensor(
        np.random.default_rng(42).standard_normal(n), dtype=dtype, device=device
    )


def build_gc_preconditioner(
    levels: list[LevelContext], mg_data: MultigridParameters, coarse_solve=None
) -> Multigrid:
    """Transfers, smoothers and the coarse solve of a gather-engine
    global-coarsening hierarchy (JAX api.build_gc_preconditioner).  A given
    ``coarse_solve`` (HPMG-local's LS V-cycle) replaces the configured one
    on ``levels[0]``, and nothing is built for that level."""
    level_dtype = levels[-1].op.dtype
    transfers: list = [None]
    for l in range(1, len(levels)):
        transfers.append(make_two_level_transfer(
            levels[l].dofh, levels[l - 1].dofh, levels[l].op, levels[l - 1].op,
            dtype=level_dtype,
        ))
    ranges = estimate_eigenvalue_ranges(
        [lv.op for lv in levels[1:]],
        [lv.inv_diag for lv in levels[1:]],
        [_seeded_normal(lv.dofh.n_dofs, level_dtype, lv.op.device) for lv in levels[1:]],
        n_iterations=mg_data.smoother.eig_cg_n_iterations,
    )
    smoothers: list = [None]
    for l in range(1, len(levels)):
        smoothers.append(ChebyshevSmoother.create(
            levels[l].op,
            levels[l].inv_diag,
            max_eigenvalue=1.2 * ranges[l - 1][0],  # deal.II safety factor
            degree=mg_data.smoother.degree,
            smoothing_range=mg_data.smoother.smoothing_range,
        ))
    if coarse_solve is None:
        coarse_solve = make_coarse_solver(
            mg_data.coarse_solver.type, levels[0].op, levels[0].dofh, levels[0].hanging,
            inv_diag=levels[0].inv_diag, mg_data=mg_data, dtype=level_dtype,
        )
    return Multigrid(
        operators=tuple(lv.op for lv in levels),
        smoothers=tuple(smoothers),
        transfers=tuple(transfers),
        coarse_solve=coarse_solve,
    )


def gc_level_plan(
    mg_type: str, tri_sequence: list[AdaptiveMesh], degree_fine: int
) -> list[tuple[AdaptiveMesh, int]]:
    """(mesh, degree) per level, coarsest first (reference:
    multigrid_throughput.cc:1546-1576).  HMG-global: every mesh of the
    geometric coarsening sequence at the fine degree; PMG: the fine mesh at
    each degree of the bisect sequence; HPMG: every mesh at degree 1, then
    the fine mesh at the higher degrees."""
    degrees = polynomial_coarsening_sequence(degree_fine, "bisect")
    n_tria = len(tri_sequence)
    if mg_type == "PMG":
        return [(tri_sequence[-1], d) for d in degrees]
    if mg_type == "HMG-global":
        return [(t, degree_fine) for t in tri_sequence]
    if mg_type == "HPMG":
        return [
            (tri_sequence[min(l, n_tria - 1)], degrees[max(0, l - n_tria + 1)])
            for l in range(len(degrees) + n_tria - 1)
        ]
    raise ValueError(f"unknown global-coarsening type {mg_type!r}")


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


def _hybrid_coarse_solver(kind: str, level: HybridLevel, mg_data: MultigridParameters):
    """The coarse solve of a hybrid hierarchy by CoarseGridSolverType
    (reference: multigrid_throughput.cc:909-1077), on slot vectors."""
    op = level.op
    if kind in ("amg", "amg_petsc", "direct", "cg_with_amg"):
        alg = make_algebraic_solver(
            level.dofh, level.hanging, op.dtype, op.device, mg_data,
            force_direct=(kind == "direct"),
            to_idx=level.to_global_idx, from_idx=level.from_global_idx,
            flavor="boomer" if kind == "amg_petsc" else "sa",
        )
        if kind != "cg_with_amg":
            return alg
        prec = alg
    elif kind == "cg_with_chebyshev":
        sm = mg_data.smoother
        lam_max, _ = estimate_eigenvalue_range(
            op, level.inv_diag, level.eig_b0, sm.eig_cg_n_iterations, use_op_dot=True
        )
        prec = ChebyshevSmoother.create(
            op, level.inv_diag,
            max_eigenvalue=1.2 * lam_max,  # deal.II safety factor
            degree=sm.degree,
            smoothing_range=sm.smoothing_range,
        )
    elif kind == "cg":
        prec = None
    else:
        raise ValueError(f"unknown coarse solver type {kind!r}")
    cs = mg_data.coarse_solver
    return make_cg_coarse_solver(op, prec, cs.maxiter, cs.abstol, cs.reltol, use_op_dot=True)


def build_gc_preconditioner_hybrid(
    levels: list[HybridLevel], mg_data: MultigridParameters, coarse_solve=None
) -> Multigrid:
    """Transfers, smoothers and the coarse solve of a global-coarsening
    hierarchy.  A given ``coarse_solve`` (HPMG-local's LS V-cycle) replaces
    the configured one on ``levels[0]``, and nothing is built for that level."""
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
    if coarse_solve is None:
        coarse_solve = _hybrid_coarse_solver(mg_data.coarse_solver.type, levels[0], mg_data)
    return Multigrid(
        operators=tuple(lv.op for lv in levels),
        smoothers=tuple(smoothers),
        transfers=tuple(transfers),
        coarse_solve=coarse_solve,
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
    mg: object = None           # the global-coarsening Multigrid (None on HMG-local)
    ls_mg: object = None        # the local-smoothing hierarchy of HMG-local and HPMG-local
    amg: object = None          # the algebraic solver of AMG and AMGPETSc
    rhs_used: torch.Tensor | None = None
    # ProfilePhases: seconds per iteration of each MG phase and of the whole
    # iteration, both from the one instrumented solve after the timed ones
    phases: dict | None = None
    phase_iteration_time: float | None = None


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mg_solve(
    fine_op,
    rhs,
    preconditioner,
    mg_data: MultigridParameters,
    n_levels: int,
    n_dofs: int,
    profile_phases: bool = False,
) -> MGSolveResult:
    """Warm-up solve + best-of-n_repetitions timed CG, the reference's
    benchmark protocol (multigrid_throughput.cc:1140-1268).  With
    ``profile_phases`` one more solve runs with the preconditioner's phase
    hooks timing every phase of its V-cycles (utils/phases.py); its
    per-iteration phase and iteration times land in ``phases`` and
    ``phase_iteration_time``, and the timed solves stay uninstrumented.

    ``fine_op`` is a HybridOperator, a MixedPrecisionOperator or (AMG,
    AMGPETSc) a gather-engine LaplaceOperator, whose dot is the plain one;
    the preconditioner is anything with a ``vmult``.  A twofloat.TF
    right-hand side selects the df32 CG: the operator and
    preconditioner apply in plain float32, and x rounds to float32 on the
    way out."""
    ctrl = mg_data.cg_parameter_study if mg_data.do_parameter_study else mg_data.cg_normal
    force = mg_data.cg_parameter_study.maxiter if mg_data.do_parameter_study else None
    df32 = isinstance(rhs, twofloat.TF)
    device = (rhs.hi if df32 else rhs).device

    def solve(precond=preconditioner):
        if df32:
            return twofloat.cg_solve_df32(
                fine_op.vmult, rhs, preconditioner=precond.vmult,
                maxiter=ctrl.maxiter, abstol=ctrl.abstol, reltol=ctrl.reltol,
                force_iterations=force, weight=fine_op.owner,
            )
        return cg_solve(
            fine_op.vmult, rhs, preconditioner=precond.vmult,
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
    # precision of the operator's own application (the inner operator of a
    # mixed-precision wrapper) puts under the attainable true residual
    if df32:
        ax = fine_op.vmult(twofloat.tf_round(res.x))
        r = twofloat.tf_axpy_f32(-1.0, ax, rhs)
        true_res = float(twofloat.tf_norm(r, fine_op.owner))
    else:
        r = rhs - fine_op.vmult(res.x)
        true_res = float(torch.sqrt(fine_op.dot(r, r)))
    eps_op = torch.finfo(getattr(fine_op, "op", fine_op).dtype).eps
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
    phases = phase_iteration_time = None
    recorder = PhaseRecorder(device)
    hooked = instrument(preconditioner, recorder) if profile_phases else None
    if hooked is not None:  # AMG and AMGPETSc have no MG phases
        _fence(device)
        res_p, seconds = recorder.span(lambda: solve(hooked))
        n_it = max(res_p.n_iterations, 1)
        phases = {k: v / n_it for k, v in recorder.seconds.items()}
        phase_iteration_time = seconds / n_it
    # a double-single x rounds to float32 at the API surface
    x = twofloat.tf_round(res.x) if df32 else res.x
    return MGSolveResult(
        x=x,
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
        phases=phases,
        phase_iteration_time=phase_iteration_time,
    )


def _outer_problem(params: RunParameters, fine: HybridLevel, device: torch.device):
    """The outer CG's operator and right-hand side on the fine level, and the
    assembled problem: (outer_op, rhs, problem).  ``rhs`` is a twofloat.TF
    pair under df32."""
    outer_dtype = number_dtype(params.number_type)
    level_dtype = fine.op.dtype
    mixed = params.number_type == "mixed"
    df32 = params.number_type == "df32"
    # outer operator: mixed wraps the float32 fine operator; df32 applies it
    # plainly (the pairs live in the CG); otherwise the outer precision's
    if mixed or df32:
        inner = (
            fine.op
            if level_dtype == torch.float32
            else make_hybrid_operator(fine.fmt, fine.hanging, device, torch.float32)
        )
        outer_op = MixedPrecisionOperator(inner) if mixed else inner
    elif outer_dtype == level_dtype:
        outer_op = fine.op
    else:
        outer_op = make_hybrid_operator(fine.fmt, fine.hanging, device, outer_dtype)
    # mixed and df32 promise a float64-accurate right-hand side: assembled in
    # float64, then (df32) split exactly into the double-single pair
    rhs_op = (
        make_hybrid_operator(fine.fmt, fine.hanging, device, torch.float64)
        if mixed or df32
        else outer_op
    )
    problem, rhs_slots = poisson.assemble_problem_hybrid(
        fine.dofh, fine.hanging, rhs_op, cell_slot_table(fine.fmt), fine.fmt,
        params.simulation_type,
    )
    rhs = twofloat.tf_split_f64_host(rhs_slots) if df32 else rhs_slots.to(outer_dtype)
    return outer_op, rhs, problem


def _timed_solve(params, fine: HybridLevel, outer_op, rhs, precond, n_levels: int,
                 t_setup: float) -> MGSolveResult:
    """Fence the set-up, run mg_solve, and return x in the global layout."""
    _fence(fine.op.device)
    setup_time = time.perf_counter() - t_setup
    result = mg_solve(
        outer_op, rhs, precond, params.mg_data, n_levels=n_levels,
        n_dofs=fine.dofh.n_dofs, profile_phases=params.profile_phases,
    )
    result.setup_time = setup_time
    result.rhs_used = twofloat.tf_round(rhs) if isinstance(rhs, twofloat.TF) else rhs
    # back to the global layout for error evaluation
    result.x = fine.to_global(result.x)
    return result


def solve_with_global_coarsening_hybrid(
    params: RunParameters, fine_mesh: AdaptiveMesh, device: torch.device
):
    """HMG-global, PMG or HPMG solve on the hybrid engine, one device.
    Returns (result, problem, levels)."""
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
    outer_op, rhs, problem = _outer_problem(params, levels[-1], device)
    mg = build_gc_preconditioner_hybrid(levels, params.mg_data)
    result = _timed_solve(
        params, levels[-1], outer_op, rhs, PreconditionMG(mg, outer_dtype), len(levels),
        t_setup,
    )
    result.mg = mg
    return result, problem, levels


@dataclass(frozen=True)
class PreconditionLS:
    """Precision and constrained-subspace wrapper around the LS V-cycle of
    either engine; callable, so that it can serve as a coarse solve
    (HPMG-local)."""

    lsmg: LocalSmoothingMGHybrid | LocalSmoothingMG
    keep: torch.Tensor          # 0 on the active mesh's constrained DoFs / slots
    outer_dtype: torch.dtype

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        x = self.lsmg.vmult(b.to(self.keep.dtype)) * self.keep
        return x.to(self.outer_dtype)

    __call__ = vmult


def solve_with_local_smoothing_hybrid(
    params: RunParameters, fine_mesh: AdaptiveMesh, device: torch.device
):
    """HMG-local or HPMG-local solve on the hybrid engine, one device
    (reference: solve_with_local_smoothing, multigrid_throughput.cc:
    1670-1873).  HPMG-local chains the p-levels of the active mesh above the
    degree-1 LS hierarchy, whose V-cycle is their coarse solve.  Returns
    (result, problem, [fine]); the LS hierarchy is ``result.ls_mg``, and
    HPMG-local's p-level Multigrid ``result.mg``."""
    t_setup = time.perf_counter()
    outer_dtype = number_dtype(params.number_type)
    level_dtype = number_dtype(params.mg_number_type)
    p = params.fe_degree_fine
    min_level = max(params.min_level, 0)
    fine = build_level_hybrid(fine_mesh, p, device, level_dtype)
    outer_op, rhs, problem = _outer_problem(params, fine, device)
    if params.type == "HMG-local":
        lsmg = build_local_smoothing_mg_hybrid(
            fine.dofh, fine.fmt, params.mg_data, device, level_dtype, min_level
        )
        precond = PreconditionLS(lsmg, fine.op.constrained_keep, outer_dtype)
        mg = None
        n_levels = len(lsmg.levels)
    else:
        degrees = polynomial_coarsening_sequence(p, "bisect")
        plevels = [
            fine if d == p else build_level_hybrid(fine_mesh, d, device, level_dtype)
            for d in degrees
        ]
        lsmg = build_local_smoothing_mg_hybrid(
            plevels[0].dofh, plevels[0].fmt, params.mg_data, device, level_dtype,
            min_level,
        )
        ls_precond = PreconditionLS(lsmg, plevels[0].op.constrained_keep, level_dtype)
        mg = build_gc_preconditioner_hybrid(plevels, params.mg_data, coarse_solve=ls_precond)
        precond = PreconditionMG(mg, outer_dtype)
        n_levels = len(degrees) + len(lsmg.levels) - 1
    result = _timed_solve(params, fine, outer_op, rhs, precond, n_levels, t_setup)
    result.mg, result.ls_mg = mg, lsmg
    return result, problem, [fine]


def _no_df32_in_2d(params: RunParameters) -> None:
    if params.number_type == "df32":
        raise ValueError(
            "NumberType=df32 (double-single outer CG) is implemented on the "
            "hybrid engine (3D); use NumberType=mixed on the gather engine"
        )


def _gather_solve(params, fine: LevelContext, problem, precond, n_levels: int,
                  t_setup: float) -> MGSolveResult:
    """Fence the set-up and run mg_solve on the gather engine."""
    _fence(fine.op.device)
    setup_time = time.perf_counter() - t_setup
    result = mg_solve(
        fine.op, problem.rhs, precond, params.mg_data, n_levels=n_levels,
        n_dofs=fine.dofh.n_dofs, profile_phases=params.profile_phases,
    )
    result.setup_time = setup_time
    result.rhs_used = problem.rhs
    return result


def solve_with_global_coarsening(
    params: RunParameters, fine_mesh: AdaptiveMesh, device: torch.device
):
    """HMG-global, PMG or HPMG on the gather engine, the 2D path (reference:
    multigrid_throughput.cc:1443-1666).  The outer CG runs the fine level's
    operator in the outer precision.  Returns (result, problem, levels)."""
    _no_df32_in_2d(params)
    t_setup = time.perf_counter()
    outer_dtype = number_dtype(params.number_type)
    level_dtype = number_dtype(params.mg_number_type)
    tri_seq = geometric_coarsening_sequence(fine_mesh, params.min_level, params.min_n_cells)
    plan = gc_level_plan(params.type, tri_seq, params.fe_degree_fine)
    levels = [build_level(mesh, degree, device, level_dtype) for mesh, degree in plan]
    fine = level_in(levels[-1], outer_dtype)
    problem = poisson.make_problem(fine.dofh, fine.hanging, fine.op, params.simulation_type)
    mg = build_gc_preconditioner(levels, params.mg_data)
    result = _gather_solve(
        params, fine, problem, PreconditionMG(mg, outer_dtype), len(levels), t_setup
    )
    result.mg = mg
    return result, problem, levels


def _global_keep(level: LevelContext, dtype: torch.dtype) -> torch.Tensor:
    """1 on the level's free DoFs, 0 on its constrained ones."""
    keep = torch.ones(level.dofh.n_dofs, dtype=dtype, device=level.op.device)
    keep[level.op.constrained] = 0
    return keep


def solve_with_local_smoothing(
    params: RunParameters, fine_mesh: AdaptiveMesh, device: torch.device
):
    """HMG-local or HPMG-local: the hybrid engine in 3D, the gather engine
    in 2D (reference: solve_with_local_smoothing,
    multigrid_throughput.cc:1670-1873).  HPMG-local chains the p-levels of
    the active mesh above the degree-1 LS hierarchy, whose V-cycle is their
    coarse solve.  Returns (result, problem, levels); the LS hierarchy is
    ``result.ls_mg``, HPMG-local's p-level Multigrid ``result.mg``."""
    if params.dim == 3:
        return solve_with_local_smoothing_hybrid(params, fine_mesh, device)
    _no_df32_in_2d(params)
    t_setup = time.perf_counter()
    outer_dtype = number_dtype(params.number_type)
    level_dtype = number_dtype(params.mg_number_type)
    p = params.fe_degree_fine
    min_level = max(params.min_level, 0)
    fine = build_level(fine_mesh, p, device, outer_dtype)
    problem = poisson.make_problem(fine.dofh, fine.hanging, fine.op, params.simulation_type)
    if params.type == "HMG-local":
        lsmg = build_local_smoothing_mg(fine.dofh, params.mg_data, device, level_dtype, min_level)
        precond = PreconditionLS(lsmg, _global_keep(fine, level_dtype), outer_dtype)
        mg = None
        n_levels = len(lsmg.levels)
    elif params.type == "HPMG-local":
        degrees = polynomial_coarsening_sequence(p, "bisect")
        plevels = [
            level_in(fine, level_dtype) if d == p
            else build_level(fine_mesh, d, device, level_dtype)
            for d in degrees
        ]
        lsmg = build_local_smoothing_mg(
            plevels[0].dofh, params.mg_data, device, level_dtype, min_level
        )
        ls_precond = PreconditionLS(lsmg, _global_keep(plevels[0], level_dtype), level_dtype)
        mg = build_gc_preconditioner(plevels, params.mg_data, coarse_solve=ls_precond)
        precond = PreconditionMG(mg, outer_dtype)
        n_levels = len(degrees) + len(lsmg.levels) - 1
    else:
        raise ValueError(f"unknown local-smoothing type {params.type!r}")
    result = _gather_solve(params, fine, problem, precond, n_levels, t_setup)
    result.mg, result.ls_mg = mg, lsmg
    return result, problem, [fine]


def solve_with_amg(params: RunParameters, fine_mesh: AdaptiveMesh, device: torch.device):
    """AMG or AMGPETSc: a single-level solve on the gather engine, CG
    preconditioned by the algebraic solver alone (reference: solve_with_amg,
    multigrid_throughput.cc:1877-1966).  AMGPETSc selects the
    BoomerAMG-parameterized flavour (amg.build_amg_boomer), AMG the
    Trilinos-ML-default analog.  Returns (result, problem, [fine])."""
    if params.number_type == "df32":
        raise ValueError(
            "NumberType=df32 is implemented on the hybrid engine solves; "
            "use NumberType=mixed for AMG"
        )
    t_setup = time.perf_counter()
    outer_dtype = number_dtype(params.number_type)
    fine = build_level(fine_mesh, params.fe_degree_fine, device, outer_dtype)
    problem = poisson.make_problem(fine.dofh, fine.hanging, fine.op, params.simulation_type)
    solver = make_coarse_solver(
        "amg_petsc" if params.type == "AMGPETSc" else "amg",
        fine.op, fine.dofh, fine.hanging, mg_data=params.mg_data, dtype=outer_dtype,
    )
    _fence(device)
    setup_time = time.perf_counter() - t_setup
    result = mg_solve(
        fine.op, problem.rhs, solver, params.mg_data, n_levels=1, n_dofs=fine.dofh.n_dofs
    )
    result.setup_time = setup_time
    result.rhs_used = problem.rhs
    result.amg = solver
    return result, problem, [fine]


def run(params: RunParameters, device: str | torch.device | None = None):
    """Reference run<dim, ...>() equivalent: build the mesh, dispatch the
    solver (multigrid_throughput.cc:2019-2396).  ``device`` None means the
    card; a CPU run passes ``"cpu"``."""
    device = resolve_device(device)
    mesh = generators.create(
        params.geometry_type, params.dim, params.n_ref_global, params.n_ref_local
    )
    return dispatch_solve(params, mesh, device)


def dispatch_solve(params: RunParameters, mesh: AdaptiveMesh, device: str | torch.device | None):
    """The reference's solver-type switch (multigrid_throughput.cc:2337-2353):
    3D multigrid on the hybrid patch engine, 2D on the gather engine."""
    device = resolve_device(device)
    if params.n_shards not in (0, 1):
        raise NotImplementedError(
            "sharded solves are not ported yet (ROADMAP item 13, multi-device)"
        )
    if params.type in ("AMG", "AMGPETSc"):
        return solve_with_amg(params, mesh, device)
    if params.type in ("HMG-global", "PMG", "HPMG"):
        if params.dim == 3:
            return solve_with_global_coarsening_hybrid(params, mesh, device)
        return solve_with_global_coarsening(params, mesh, device)
    if params.type in ("HMG-local", "HPMG-local"):
        return solve_with_local_smoothing(params, mesh, device)
    raise ValueError(f"unknown solver type {params.type!r}")
