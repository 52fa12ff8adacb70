"""Per-phase multigrid timing and the port's spans (the reference's 7 MG
signal hooks).

The reference instruments pre-smooth / residuum / restrict / coarse /
prolong / edge-prolong / post-smooth per level per repetition through
deal.II's Multigrid signals (multigrid_throughput.cc:1152-1234) and prints
them as ``time_pre .. time_post`` plus the two preconditioner-boundary
timers ``time_to_mg`` / ``time_to_global`` (:1381-1401); ``time_cg`` is the
iteration time minus their sum (:1270-1283).

Every V-cycle phase runs through its object's ``hook``, called as
``hook(phase, level, fn, *args)`` (solvers/multigrid.py,
solvers/local_smoothing.py; level 0 is the coarsest).  Three hooks live
here:

  * ``untimed``, the default: applies the phase, inside a profiler range
    named after the phase and its level while a profiler records;
  * ``PhaseRecorder``: times every phase of the real V-cycles, per phase
    and per (phase, level).  On the card two CUDA events bracket each phase
    and the solve on one stream, so the phases are disjoint parts of the
    solve and their sum cannot exceed it; on the CPU ``perf_counter`` does
    the same.  ``instrument`` gives a copy of a preconditioner whose hooks
    are a recorder, ``api.mg_solve`` runs one such solve after the timed
    ones, and its per-level sums are the CLI's verbose per-level table;
  * ``finite_check``, debug mode's (``MGTPU_DEBUG``): ``checked`` returns a
    copy of a preconditioner whose phases run through it, or, for one
    without V-cycle phases, a ``FiniteChecked`` wrapper that checks its
    whole output.

Spans.  Names start with ``mgtpu.``, then the layer, then the part, and end
in ``@L<level>`` where there is one: ``mgtpu.smoother.pre@L7``,
``mgtpu.operator.exchange``, ``mgtpu.cg.iteration``.  The solve path's
spans (``untimed``, ``spanned``, ``span``) exist only while a
``torch.profiler`` records (``torch.autograd.profiler._is_profiler_enabled``);
otherwise each costs that one attribute read.  They are
``_RecordFunctionFast`` ranges: a CPU operator event on the profiler's
clock, nested as the calls nest, that is never mirrored onto the device
timeline (``record_function`` is, as a ``gpu_user_annotation``, which a
trace reader would count as device activity).  The set-up's spans
(``setup_span``) are always on: host clock, each ended by a device
synchronize on CUDA, kept per (path of names) in ``SETUP``, and passed to a
recording profiler as the same ranges.

CUDA graphs (solvers/vcycle_graph.py).  A replay runs no hook, so it
records no phase span, only ``mgtpu.vcycle.graph_replay`` inside
``mgtpu.vcycle.precondition``; a copy made by ``instrument`` or
``checked`` runs eagerly.  ``GRAPHS`` counts them.

AMG.  An AMG coarse solve (solvers/amg.py) runs its own phases through its
own hook, ``amg_smooth``, ``amg_transfer`` and ``amg_dense`` at its own
levels, inside the multigrid's ``cs``; ``instrument`` hooks them with the
V-cycle's.  Their spans end in ``@A<level>`` (``mgtpu.amg.amg_dense@A6``,
0 the AMG's finest), so that no reader takes them for a multigrid level.
Its set-up spans are ``mgtpu.setup.amg_build``, ``.amg_upload`` and
``.amg_factor``, and ``AMG_SHAPE`` holds the shape of the latest
hierarchy built.

This module imports nothing else of the package, so that ``mesh/``,
``ops/`` and ``solvers/`` can import it.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from contextlib import nullcontext
from typing import Callable, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

PHASES = ("pre", "residuum", "res", "cs", "pro", "edge_pro", "post")
#: the V-cycle's phases and its boundary with the outer solve: the phase
#: times ``api.mg_solve`` reports (the CLI's columns)
VCYCLE_KEYS = PHASES + ("to_mg", "to_global")
#: the phases of an AMG coarse solve (solvers/amg.py), at the AMG's own
#: levels (0 the finest): its Jacobi sweeps, its residuals and transfers,
#: its dense coarsest solve.  They split the AMG's application and nest
#: inside the multigrid's ``cs``.
AMG_PHASES = ("amg_smooth", "amg_transfer", "amg_dense")
KEYS = VCYCLE_KEYS + AMG_PHASES
PREFIX = "mgtpu."
#: the layer in a phase's span name (BENCHMARK.json's per-layer metrics);
#: to_mg / to_global are the V-cycle's boundary with the outer solve
PHASE_LAYER = {
    "pre": "smoother", "post": "smoother", "residuum": "operator",
    "res": "transfer", "pro": "transfer", "cs": "coarse", "edge_pro": "ls_interface",
    "to_mg": "vcycle", "to_global": "vcycle",
    "amg_smooth": "amg", "amg_transfer": "amg", "amg_dense": "amg",
}
#: a whole preconditioner application (PreconditionMG, the LS V-cycle)
PRECONDITION = PREFIX + "vcycle.precondition"
#: the launch of a preconditioner's CUDA graph (solvers/vcycle_graph.py),
#: inside PRECONDITION
GRAPH_REPLAY = PREFIX + "vcycle.graph_replay"
CG_SOLVE = PREFIX + "cg.solve"
CG_ITERATION = PREFIX + "cg.iteration"
_NULL = nullcontext()


def phase_span_name(phase: str, level: int | None) -> str:
    layer = PHASE_LAYER.get(phase, "vcycle")
    if level is None:
        return f"{PREFIX}{layer}.{phase}"
    return f"{PREFIX}{layer}.{phase}@{'A' if phase in AMG_PHASES else 'L'}{level}"


def spanned(name: str, fn: Callable, *args):
    """``fn(*args)``, inside the range ``name`` while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*args)
    with _RecordFunctionFast(name):
        return fn(*args)


def span(name: str):
    """A context: the range ``name`` while a profiler records, else nothing."""
    return _RecordFunctionFast(name) if _autograd_profiler._is_profiler_enabled else _NULL


def untimed(phase: str, level: int | None, fn: Callable, *args):
    """The default phase hook: apply the phase, time nothing (a range
    named after the phase and its level while a profiler records)."""
    if not _autograd_profiler._is_profiler_enabled:
        return fn(*args)
    with _RecordFunctionFast(phase_span_name(phase, level)):
        return fn(*args)


def finite_check(phase: str, level: int | None, fn: Callable, *args):
    """The debug-mode phase hook: apply the phase (a V-cycle phase, or a
    whole preconditioner without such phases), then raise FloatingPointError
    naming it if its output holds a NaN or an infinity (torch has no
    ``jax_debug_nans``).  One host synchronisation per phase."""
    out = untimed(phase, level, fn, *args)
    parts = out if isinstance(out, (list, tuple)) else (out,)
    if not all(bool(torch.isfinite(t).all()) for t in parts):
        raise FloatingPointError(
            f"debug mode (MGTPU_DEBUG): non-finite value in the output of the phase {phase!r}"
        )
    return out


class PhaseRecorder:
    """A phase hook that times every call: CUDA events on the card,
    ``perf_counter`` on the CPU.  ``span`` times a whole solve the same
    way.  ``seconds`` holds the sums per phase (every key of ``KEYS``),
    ``level_seconds`` per (phase, level), each of a phase's own time: a
    phase that runs inside another is taken out of the enclosing one's.
    The AMG phases (``AMG_PHASES``, at the AMG's own levels) run inside
    ``cs``, which then holds the coarse solve's time outside the AMG.  So
    the phases are disjoint parts of the solve and their sum is at most
    the span; ``vcycle_seconds`` folds the AMG back into ``cs``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.seconds = dict.fromkeys(KEYS, 0.0)
        self.level_seconds: dict = {}
        self._events: list = []     # (phase, level, start, stop, inner events)
        self._open: list = []       # the inner events of each running phase

    def _mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _elapsed(self, start, stop) -> float:
        return start.elapsed_time(stop) * 1e-3 if self.cuda else stop - start

    def __call__(self, phase: str, level: int, fn, *args):
        start = self._mark()
        self._open.append([])
        try:
            out = untimed(phase, level, fn, *args)
        finally:
            inner = self._open.pop()
        if self._open:
            self._open[-1].append(len(self._events))
        self._events.append((phase, level, start, self._mark(), inner))
        return out

    def span(self, fn):
        """(fn(), seconds of the call); settles every recorded phase."""
        start = self._mark()
        out = fn()
        stop = self._mark()
        if self.cuda:
            stop.synchronize()
        whole = [self._elapsed(a, b) for _, _, a, b, _ in self._events]
        for (phase, level, _, _, inner), s in zip(self._events, whole):
            s -= sum(whole[i] for i in inner)
            self.seconds[phase] += s
            self.level_seconds[phase, level] = self.level_seconds.get((phase, level), 0.0) + s
        self._events.clear()
        return out, self._elapsed(start, stop)

    def vcycle_seconds(self) -> dict:
        """The sums over ``VCYCLE_KEYS``, an AMG coarse solve's phases
        counted in ``cs`` (the CLI's columns)."""
        out = {k: self.seconds[k] for k in VCYCLE_KEYS}
        out["cs"] += sum(self.seconds[k] for k in AMG_PHASES)
        return out

    def per_level(self, n: int = 1) -> dict:
        """The per-level sums over ``n`` (V-cycles), as
        ``format_per_level_table`` takes them: ``out[phase][l - 1]`` for the
        levels l = 1..L of each phase in ``PHASES``, and ``out["cs"]`` the
        coarse solve's one entry, an AMG's phases included."""
        top = max((lv for ph, lv in self.level_seconds if ph in PHASES), default=0)
        out = {
            ph: [self.level_seconds.get((ph, lv), 0.0) / n for lv in range(1, top + 1)]
            for ph in PHASES if ph != "cs"
        }
        amg = sum(s for (ph, _), s in self.level_seconds.items() if ph in AMG_PHASES)
        out["cs"] = [(self.level_seconds.get(("cs", 0), 0.0) + amg) / n]
        return out


def hooked(obj, hook: Callable, phases: tuple = KEYS):
    """``obj.with_hook(hook, phases)``; ``obj`` where it does not answer."""
    with_hook = getattr(obj, "with_hook", None)
    return obj if with_hook is None else with_hook(hook, phases)


def hook_field(obj, name: str, hook: Callable, phases: tuple):
    """``obj``, or a copy whose field ``name`` is ``hooked`` where that changes it."""
    part = getattr(obj, name)
    new = hooked(part, hook, phases)
    return obj if new is part else dataclasses.replace(obj, **{name: new})


def instrument(precond, hook):
    """A copy of ``precond`` whose V-cycle phases, and those of an AMG
    coarse solve, run through ``hook``, or None for a preconditioner
    without multigrid phases (AMG, AMGPETSc)."""
    copy = hooked(precond, hook, VCYCLE_KEYS)
    return None if copy is precond else copy


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
        return finite_check(self.phase, None, self.inner.vmult, b)


def sanitizer_enabled() -> bool:
    """Debug mode, the JAX package's ``MGTPU_DEBUG`` (any value but empty or
    "0"): ``ops.hybrid_format.verify_format`` at each level's build, ``checked``."""
    return os.environ.get("MGTPU_DEBUG", "") not in ("", "0")


def checked(precond, phase: str = "amg"):
    """``precond`` itself, or in debug mode (``MGTPU_DEBUG``) a copy whose
    V-cycle phases run through ``finite_check``; a preconditioner without
    such phases is checked as a whole, under the name ``phase``."""
    if not sanitizer_enabled():
        return precond
    return instrument(precond, finite_check) or FiniteChecked(precond, phase)


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


# ---------------------------------------------------------------------------
# set-up spans
# ---------------------------------------------------------------------------


class SetupRecord(NamedTuple):
    name: str
    parent: tuple           # names of the enclosing set-up spans, outermost first
    seconds: float
    count: int


class SetupSpans:
    """The set-up's spans, kept in memory: seconds and count per path of
    names (the span and the set-up spans around it)."""

    def __init__(self):
        self._totals: dict = {}     # path -> [seconds, count]
        self._path: tuple = ()

    def span(self, name: str) -> "_SetupSpan":
        return _SetupSpan(self, name)

    def records(self) -> list:
        return [SetupRecord(p[-1], p[:-1], s, n) for p, (s, n) in self._totals.items()]

    def seconds(self, name: str) -> float:
        """Seconds of the span ``name`` so far, wherever it ran."""
        return sum(s for p, (s, _) in self._totals.items() if p[-1] == name)

    def clear(self) -> None:
        self._totals.clear()


class _SetupSpan:
    def __init__(self, owner: SetupSpans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.range = span(self.name)
        self.range.__enter__()
        owner = self.owner
        self.outer, self.path = owner._path, owner._path + (self.name,)
        owner._path = self.path
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            seconds = time.perf_counter() - self.t0
        finally:
            self.range.__exit__(*exc)
            self.owner._path = self.outer
        total = self.owner._totals.setdefault(self.path, [0.0, 0])
        total[0] += seconds
        total[1] += 1
        return False


#: the process's set-up spans (the benchmark's metric readers take them)
SETUP = SetupSpans()


def setup_span(name: str):
    """Decorator: every call of the function is the set-up span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with SETUP.span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# ---------------------------------------------------------------------------
# the preconditioners' CUDA graphs
# ---------------------------------------------------------------------------


class GraphCounts:
    """How often the preconditioners' CUDA graphs (solvers/vcycle_graph.py)
    engage: ``captures`` and their ``capture_s`` (host seconds, warm-up
    included), ``replays``, and ``eager``: the applications on CUDA that ran
    without their graph, per reason ("hook", "sharded", "coarse",
    "capturing", "input")."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.eager: dict = {}

    def summary(self) -> dict:
        return {"captures": self.captures, "replays": self.replays,
                "eager": dict(self.eager), "capture_s": self.capture_s}


#: the process's graph counts
GRAPHS = GraphCounts()


# ---------------------------------------------------------------------------
# the shapes of the AMG hierarchies built
# ---------------------------------------------------------------------------


#: The shape of the latest AMG hierarchy built in the process (solvers/
#: amg.py replaces it at each build; empty before any), for counters and
#: least bytes: per level, finest first, its ``rows``, the stored entries
#: of A (``nnz_A``) and of the prolongator from the next coarser level
#: (``nnz_P``; 0 on the finest), the ELL widths ``K_A``, ``K_P``, ``K_PT``,
#: ``bytes`` and ``omega``; the ELL values' dtype; the dense coarsest level's rows, the
#: nonzero entries of its matrix's lower triangle, diagonal included
#: (``dense_nnz``: the fewest a factor holds), and its factor's dtype;
#: ``n_cycles`` and ``n_smooth``.
AMG_SHAPE: dict = {}
