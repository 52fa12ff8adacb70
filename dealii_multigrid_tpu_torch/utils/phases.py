"""Per-phase multigrid timing (the reference's 7 MG signal hooks).

The reference instruments pre-smooth / residuum / restrict / coarse /
prolong / edge-prolong / post-smooth per level per repetition through
deal.II's Multigrid signals (multigrid_throughput.cc:1152-1234) and prints
them as ``time_pre .. time_post`` plus the two preconditioner-boundary
timers ``time_to_mg`` / ``time_to_global`` (:1381-1401).

Here a phase is applied at all its levels ``n_loop`` times after one
warm-up application, between two CUDA events on the card and two readings
of ``perf_counter`` on the CPU; the result is seconds per application, the
best of three such measurements.  On the card the events bracket the
device's work as the host enqueues it, so a phase whose kernels are short
reads as its host dispatch time, which is what a solve pays for it too.

Handles both the global-coarsening Multigrid and LocalSmoothingMGHybrid;
for the latter ``edge_pro`` times the refinement-edge interface operators
(interface_down / interface_up, reference include/operator.h:191-226) and
to_mg / to_global time the copy_to_mg / copy_from_mg index maps.

The phase inputs are random vectors from fixed NumPy seeds, drawn in the
global layout and spread to the slots with ``fmt.from_global``: slots that
hold the same DoF must carry the same value, or the operator's constraint
scatter is not defined.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..solvers.multigrid import PreconditionMG

PHASES = ("pre", "residuum", "res", "cs", "pro", "edge_pro", "post")


def _loop_time(fn, device: torch.device, n_loop: int = 8, reps: int = 3) -> float:
    """Seconds per application of ``fn()``: after one warm-up, the best of
    ``reps`` measurements of ``n_loop`` applications each, between two CUDA
    events (card) or clock readings (CPU).  The best, because the solve's
    time is the best of its repetitions too and the host's speed varies."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(n_loop):
                fn()
            stop.record()
            torch.cuda.synchronize(device)
            seconds = start.elapsed_time(stop) * 1e-3
        else:
            t0 = time.perf_counter()
            for _ in range(n_loop):
                fn()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / n_loop)
    return best


def _consistent_random(op, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """A random slot vector of ``op``'s layout whose duplicate slots agree."""
    if op.fmt is None:
        raise ValueError("phase profiling needs operators built by make_hybrid_operator")
    g = np.random.default_rng(seed).standard_normal(op.n_dofs)
    return torch.as_tensor(op.fmt.from_global(g), dtype=dtype, device=op.device)


def _gc_vectors(mg, dtype):
    n = mg.n_levels
    d = [_consistent_random(mg.operators[l], dtype, 100 + l) for l in range(n)]
    x = [_consistent_random(mg.operators[l], dtype, 200 + l) for l in range(n)]
    return d, x


def _ls_vectors(lsmg, dtype):
    d = [_consistent_random(lv.op, dtype, 300 + i) for i, lv in enumerate(lsmg.levels)]
    x = [_consistent_random(lv.op, dtype, 400 + i) for i, lv in enumerate(lsmg.levels)]
    return d, x


def _gc_phase_fns(mg, d, x, l: int) -> dict:
    """The five per-level phases of level ``l`` >= 1 as thunks."""
    sm, op, tr = mg.smoothers[l], mg.operators[l], mg.transfers[l]
    return {
        "pre": lambda: sm.vmult(d[l]),
        "residuum": lambda: d[l] - op.vmult(x[l]),
        "res": lambda: tr.restrict(d[l]),
        "pro": lambda: tr.prolong(d[l - 1]),
        "post": lambda: sm.step(x[l], d[l]),
    }


def _ls_phase_fns(lsmg, d, x, l: int) -> dict:
    sm, lev, tr = lsmg.smoothers[l], lsmg.levels[l], lsmg.transfers[l]
    return {
        "pre": lambda: sm.vmult(d[l]),
        "residuum": lambda: d[l] - lev.vmult(x[l]),
        "edge_pro": lambda: lev.interface_down(x[l]) + lev.interface_up(x[l]),
        "res": lambda: tr.restrict(d[l]),
        "pro": lambda: tr.prolong(d[l - 1]),
        "post": lambda: sm.step(x[l], d[l]),
    }


def _summed(level_fns: list, device, n_loop: int) -> dict:
    """Each phase applied at all its levels per application, timed once."""
    out = {ph: 0.0 for ph in PHASES}
    for ph in level_fns[0] if level_fns else ():
        fns = [f[ph] for f in level_fns]
        out[ph] = _loop_time(lambda: [f() for f in fns], device, n_loop)
    return out


def _per_level(level_fns: list, device, n_loop: int) -> dict:
    out = {ph: [] for ph in PHASES}
    for fns in level_fns:
        for ph in PHASES:
            if ph == "cs":
                continue
            out[ph].append(_loop_time(fns[ph], device, n_loop) if ph in fns else 0.0)
    return out


def profile_v_cycle(mg, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Per-phase seconds (one V-cycle, summed over levels) for a
    global-coarsening Multigrid (solvers/multigrid.py); ``edge_pro`` is 0."""
    d, x = _gc_vectors(mg, b.dtype)
    fns = [_gc_phase_fns(mg, d, x, l) for l in range(1, mg.n_levels)]
    out = _summed(fns, b.device, n_loop)
    out["cs"] = _loop_time(lambda: mg.coarse_solve(d[0]), b.device, n_loop)
    return out


def profile_ls_cycle(lsmg, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Per-phase seconds for a LocalSmoothingMGHybrid, including the
    refinement-edge interface work (edge_pro) and the copy_to_mg /
    copy_from_mg boundaries (to_mg / to_global); ``b`` is a vector of the
    active mesh's slot layout."""
    d, x = _ls_vectors(lsmg, b.dtype)
    fns = [_ls_phase_fns(lsmg, d, x, l) for l in range(1, len(lsmg.levels))]
    out = _summed(fns, b.device, n_loop)
    out["cs"] = _loop_time(lambda: lsmg.coarse_solve(d[0]), b.device, n_loop)

    def to_mg():
        outs = []
        for lev in lsmg.levels:
            dd = b.new_zeros(lev.n_dofs)
            dd[lev.to_slots] = b[lev.to_src]
            outs.append(dd * lev.keep)
        return outs

    def to_global():
        o = b.new_zeros(lsmg.n_dofs_global)
        for lev, u in zip(lsmg.levels, x):
            o[lev.from_slots] = u[lev.from_src]
        return o

    out["to_mg"] = _loop_time(to_mg, b.device, n_loop)
    out["to_global"] = _loop_time(to_global, b.device, n_loop)
    return out


def profile_v_cycle_per_level(mg, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Per-level per-phase seconds for a global-coarsening Multigrid:
    ``out[phase][l-1]`` = seconds of that phase at level l (levels 1..L; the
    coarse solve is its own 'cs' single-entry list).  The reference prints
    per-level min/max/avg matrices over MPI ranks
    (multigrid_throughput.cc:1285-1379, mg_tools.h tables); on one device
    there is one value per cell."""
    d, x = _gc_vectors(mg, b.dtype)
    fns = [_gc_phase_fns(mg, d, x, l) for l in range(1, mg.n_levels)]
    out = _per_level(fns, b.device, n_loop)
    out["cs"] = [_loop_time(lambda: mg.coarse_solve(d[0]), b.device, n_loop)]
    return out


def profile_ls_cycle_per_level(lsmg, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Per-level per-phase seconds for a LocalSmoothingMGHybrid (see
    profile_v_cycle_per_level), including the refinement-edge interface
    work per level."""
    d, x = _ls_vectors(lsmg, b.dtype)
    fns = [_ls_phase_fns(lsmg, d, x, l) for l in range(1, len(lsmg.levels))]
    out = _per_level(fns, b.device, n_loop)
    out["cs"] = [_loop_time(lambda: lsmg.coarse_solve(d[0]), b.device, n_loop)]
    return out


def format_per_level_table(per_level: dict) -> str:
    """Reference-shaped per-level phase table (mg_tools.h-style rows)."""
    phases = [ph for ph in PHASES if ph != "cs"]
    L = max((len(per_level.get(ph, [])) for ph in phases), default=0)
    head = "level " + " ".join(f"{ph:>10}" for ph in phases)
    lines = [head]
    for i in range(L):
        cells = " ".join(
            f"{per_level[ph][i]:10.3e}" if i < len(per_level.get(ph, []))
            else f"{'-':>10}"
            for ph in phases
        )
        lines.append(f"{i + 1:<5} " + cells)
    cs = per_level.get("cs", [])
    if cs:
        lines.append(f"coarse solve: {cs[0]:.3e} s")
    return "\n".join(lines)


def _ls_of(precond):
    """(LocalSmoothingMGHybrid, its level dtype) of a PreconditionLS wrapper
    (api.py) or a bare hierarchy."""
    lsmg = getattr(precond, "lsmg", precond)
    return lsmg, lsmg.levels[-1].keep.dtype


def profile_preconditioner(precond, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Dispatch on preconditioner type; always returns the 7 PHASES plus
    to_mg / to_global."""
    if isinstance(precond, PreconditionMG):
        level_dtype = precond.mg.operators[-1].dtype
        b_level = b.to(level_dtype)
        out = profile_v_cycle(precond.mg, b_level, n_loop)
        # precision-boundary casts (reference connect_transfer_to_mg/global)
        out["to_mg"] = _loop_time(lambda: b.to(level_dtype), b.device, n_loop)
        out["to_global"] = _loop_time(lambda: b_level.to(b.dtype), b.device, n_loop)
        return out
    lsmg, level_dtype = _ls_of(precond)
    return profile_ls_cycle(lsmg, b.to(level_dtype), n_loop)


def profile_preconditioner_per_level(precond, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Per-level dispatch (see profile_preconditioner)."""
    if isinstance(precond, PreconditionMG):
        return profile_v_cycle_per_level(
            precond.mg, b.to(precond.mg.operators[-1].dtype), n_loop
        )
    lsmg, level_dtype = _ls_of(precond)
    return profile_ls_cycle_per_level(lsmg, b.to(level_dtype), n_loop)
