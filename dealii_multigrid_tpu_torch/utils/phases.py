"""Per-phase multigrid timing (the reference's 7 MG signal hooks).

The reference instruments pre-smooth / residuum / restrict / coarse /
prolong / edge-prolong / post-smooth per level per repetition through
deal.II's Multigrid signals (multigrid_throughput.cc:1152-1234) and prints
them as ``time_pre .. time_post`` plus the two preconditioner-boundary
timers ``time_to_mg`` / ``time_to_global`` (:1381-1401); ``time_cg`` is the
iteration time minus their sum (:1270-1283).

Two measurements live here:

  * ``PhaseRecorder`` and ``instrument``: the in-solve timers.  Every
    V-cycle phase runs through its object's ``hook`` (solvers/multigrid.py,
    solvers/local_smoothing.py); ``instrument`` gives a copy of a
    preconditioner whose hooks record each phase of the real V-cycles, and
    ``api.mg_solve`` runs one such solve after the timed ones.  On the card
    two CUDA events bracket each phase and the solve on one stream, so the
    phases are disjoint parts of the solve and their sum cannot exceed it;
    on the CPU ``perf_counter`` does the same.
  * ``profile_preconditioner_per_level``: each phase at each level applied
    in loops of its own (after one warm-up, the best of three measurements
    of ``n_loop`` applications); the CLI's verbose per-level table.
    ``profile_preconditioner`` sums it over the levels.

``checked`` uses the same hook mechanism for debug mode: with
``MGTPU_DEBUG`` set it returns a copy of a preconditioner whose phases run
through ``solvers.multigrid.finite_check``, or, for one without V-cycle
phases, a ``FiniteChecked`` wrapper that checks its whole output.

Both handle the global-coarsening Multigrid and both local-smoothing
hierarchies; for the latter ``edge_pro`` times the refinement-edge
interface operators (include/operator.h:191-226) and to_mg / to_global the
copy_to_mg / copy_from_mg maps.  The loop inputs are random vectors from
fixed NumPy seeds, drawn in the global layout: a hybrid level spreads them
to its slots with ``fmt.from_global`` (slots that hold one DoF must carry
one value, or the constraint scatter is not defined); a gather-engine
vector is in the global layout already.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops.hybrid import HybridOperator
from ..ops.hybrid_format import sanitizer_enabled
from ..solvers.multigrid import PreconditionMG, finite_check

PHASES = ("pre", "residuum", "res", "cs", "pro", "edge_pro", "post")
KEYS = PHASES + ("to_mg", "to_global")


class PhaseRecorder:
    """A phase hook that times every call: CUDA events on the card,
    ``perf_counter`` on the CPU.  ``span`` times a whole solve the same
    way, so the phases' sum is at most the span."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.seconds = dict.fromkeys(KEYS, 0.0)
        self._events: list = []

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _elapsed(self, start, stop) -> float:
        return start.elapsed_time(stop) * 1e-3 if self.cuda else stop - start

    def __call__(self, phase: str, fn, *args):
        start = self._mark()
        out = fn(*args)
        self._events.append((phase, start, self._mark()))
        return out

    def span(self, fn):
        """(fn(), seconds of the call); settles every recorded phase."""
        start = self._mark()
        out = fn()
        stop = self._mark()
        if self.cuda:
            stop.synchronize()
        for phase, a, b in self._events:
            self.seconds[phase] += self._elapsed(a, b)
        self._events.clear()
        return out, self._elapsed(start, stop)


def instrument(precond, hook):
    """A copy of ``precond`` whose V-cycle phases run through ``hook``, or
    None for a preconditioner without multigrid phases (AMG, AMGPETSc)."""
    if isinstance(precond, PreconditionMG):
        return dataclasses.replace(
            precond, mg=dataclasses.replace(precond.mg, hook=hook), hook=hook
        )
    lsmg = getattr(precond, "lsmg", None)
    if lsmg is not None:  # api.PreconditionLS
        return dataclasses.replace(precond, lsmg=dataclasses.replace(lsmg, hook=hook))
    if hasattr(precond, "copy_to_mg"):  # a bare local-smoothing hierarchy
        return dataclasses.replace(precond, hook=hook)
    return None


@dataclasses.dataclass(frozen=True)
class FiniteChecked:
    """Debug mode's check of a preconditioner without V-cycle phases (AMG,
    AMGPETSc, a Schur solve, the w-BFBT Kp solve): its whole application
    runs through ``finite_check`` as one phase named ``phase``, and its
    input is checked too, since a CG inside (the Kp solve's) stops at a
    non-finite residual and returns zeros, which would hide the NaN."""

    inner: object
    phase: str

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        if not bool(torch.isfinite(b).all()):
            raise FloatingPointError(
                f"debug mode (MGTPU_DEBUG): non-finite value in the input of the phase {self.phase!r}"
            )
        return finite_check(self.phase, self.inner.vmult, b)


def checked(precond, phase: str = "amg"):
    """``precond`` itself, or in debug mode (``MGTPU_DEBUG``) a copy whose
    V-cycle phases run through ``solvers.multigrid.finite_check``; a
    preconditioner without such phases is checked as a whole, under the
    name ``phase``."""
    if not sanitizer_enabled():
        return precond
    return instrument(precond, finite_check) or FiniteChecked(precond, phase)


# ---------------------------------------------------------------------------
# phases timed in loops of their own
# ---------------------------------------------------------------------------


def _loop_time(fn, device: torch.device, n_loop: int = 8, reps: int = 3) -> float:
    """Seconds per application of ``fn()``: after one warm-up, the best of
    ``reps`` measurements of ``n_loop`` applications each, between two CUDA
    events (card) or clock readings (CPU)."""
    def loop():
        for _ in range(n_loop):
            fn()

    fn()
    rec = PhaseRecorder(device)
    best = float("inf")
    for _ in range(reps):
        if rec.cuda:
            torch.cuda.synchronize(device)
        best = min(best, rec.span(loop)[1] / n_loop)
    return best


def _consistent_random(op, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """A random vector of ``op``'s layout: for a hybrid operator a slot
    vector whose duplicate slots agree, else a global-layout vector."""
    g = np.random.default_rng(seed).standard_normal(op.n_dofs)
    if isinstance(op, HybridOperator):
        if op.fmt is None:
            raise ValueError("phase profiling needs operators built by make_hybrid_operator")
        g = op.fmt.from_global(g)
    return torch.as_tensor(g, dtype=dtype, device=op.device)


def _gc_vectors(mg, dtype):
    n = mg.n_levels
    d = [_consistent_random(mg.operators[l], dtype, 100 + l) for l in range(n)]
    x = [_consistent_random(mg.operators[l], dtype, 200 + l) for l in range(n)]
    return d, x


def _ls_vectors(lsmg, dtype):
    ops = [getattr(lv, "op", lv) for lv in lsmg.levels]
    d = [_consistent_random(op, dtype, 300 + i) for i, op in enumerate(ops)]
    x = [_consistent_random(op, dtype, 400 + i) for i, op in enumerate(ops)]
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


def _per_level(level_fns: list, device, n_loop: int) -> dict:
    out = {ph: [] for ph in PHASES}
    for fns in level_fns:
        for ph in PHASES:
            if ph == "cs":
                continue
            out[ph].append(_loop_time(fns[ph], device, n_loop) if ph in fns else 0.0)
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
    """Per-level per-phase seconds for a local-smoothing hierarchy (see
    profile_v_cycle_per_level), including the refinement-edge interface
    work per level."""
    d, x = _ls_vectors(lsmg, b.dtype)
    fns = [_ls_phase_fns(lsmg, d, x, l) for l in range(1, len(lsmg.levels))]
    out = _per_level(fns, b.device, n_loop)
    out["cs"] = [_loop_time(lambda: lsmg.coarse_solve(d[0]), b.device, n_loop)]
    return out


def _sum_levels(per_level: dict) -> dict:
    return {ph: float(sum(per_level[ph])) for ph in PHASES}


def profile_v_cycle(mg, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Per-phase seconds (one V-cycle: the per-level times summed over
    levels) for a global-coarsening Multigrid (solvers/multigrid.py);
    ``edge_pro`` is 0."""
    return _sum_levels(profile_v_cycle_per_level(mg, b, n_loop))


def profile_ls_cycle(lsmg, b: torch.Tensor, n_loop: int = 8) -> dict:
    """Per-phase seconds for a local-smoothing hierarchy of either engine
    (the per-level times summed), including the refinement-edge interface
    work (edge_pro) and the copy_to_mg / copy_from_mg boundaries (to_mg /
    to_global); ``b`` is a vector of the active mesh's layout."""
    out = _sum_levels(profile_ls_cycle_per_level(lsmg, b, n_loop))
    _, x = _ls_vectors(lsmg, b.dtype)
    out["to_mg"] = _loop_time(lambda: lsmg.copy_to_mg(b), b.device, n_loop)
    out["to_global"] = _loop_time(lambda: lsmg.copy_from_mg(x, b), b.device, n_loop)
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
    """(local-smoothing hierarchy, its level dtype) of a PreconditionLS
    wrapper (api.py) or a bare hierarchy."""
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
