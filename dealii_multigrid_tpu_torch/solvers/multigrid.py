"""Multigrid V-cycle and the preconditioner wrapper.

Mirror of deal.II's Multigrid + PreconditionMG as the reference's mg_solve
drives them (multigrid_throughput.cc:1093-1133): per-level Chebyshev pre-
and post-smoothing, residual restriction, coarse solve, prolongation, and
the precision boundary between the outer Krylov solve and the MG levels.

Every phase runs through the object's ``hook`` (``hook(phase, level, fn,
*args)`` returns ``fn(*args)``; level 0 is the coarsest), the analog of the
reference's Multigrid signals (multigrid_throughput.cc:1152-1234).  The
default hook, ``untimed`` (utils/phases.py), only calls, inside a profiler
range named after the phase and its level while a profiler records; the
profiled solve of ``ProfilePhases`` runs a copy whose hook times each phase
at each level (``utils.phases.PhaseRecorder``), and debug mode
(``MGTPU_DEBUG``) a copy whose hook is ``finite_check``, so the timed solves
carry no event, no check and no branch.  A whole application of
``PreconditionMG`` is the range ``mgtpu.vcycle.precondition``.  Built on a
CUDA device, ``PreconditionMG`` captures its application as one CUDA graph
and replays it (solvers/vcycle_graph.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

# finite_check, debug mode's hook, is named here beside the default one
from ..utils.phases import PRECONDITION, finite_check, span, untimed  # noqa: F401
from .vcycle_graph import VCycleGraph, static_reason


def residual(op, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return b - op.vmult(x)


def prolong_add(transfer, x: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    return x + transfer.prolong(xc)


@dataclass(frozen=True)
class Multigrid:
    """V(1,1)-cycle over a level hierarchy (coarsest = index 0)."""

    operators: tuple
    smoothers: tuple        # smoothers[0] unused (None)
    transfers: tuple        # transfers[l]: level l <-> l-1; transfers[0] None
    coarse_solve: object    # called as coarse_solve(b)
    hook: Callable = untimed

    @property
    def n_levels(self) -> int:
        return len(self.operators)

    def _v_cycle(self, level: int, b: torch.Tensor) -> torch.Tensor:
        ph = self.hook
        if level == 0:
            return ph("cs", 0, self.coarse_solve, b)
        sm = self.smoothers[level]
        tr = self.transfers[level]
        x = ph("pre", level, sm.vmult, b)                          # zero initial guess
        r = ph("residuum", level, residual, self.operators[level], b, x)
        bc = ph("res", level, tr.restrict, r)
        xc = self._v_cycle(level - 1, bc)                          # coarse correction
        x = ph("pro", level, prolong_add, tr, x, xc)
        return ph("post", level, sm.step, x, b)

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        """Apply as a preconditioner: one V-cycle from a zero guess."""
        return self._v_cycle(self.n_levels - 1, b)


@dataclass(frozen=True)
class PreconditionMG:
    """Precision boundary between the outer Krylov solve and the MG levels
    (reference: float MG levels under a double outer CG,
    multigrid_throughput.cc:528-550); the two casts are the phases
    ``to_mg`` and ``to_global``.  On a CUDA device the whole application
    is one CUDA graph, captured here and replayed where it is sound
    (solvers/vcycle_graph.py); ``graph`` is no init field, so a copy made
    with ``dataclasses.replace`` (``utils.phases.instrument``) decides
    anew."""

    mg: Multigrid
    outer_dtype: torch.dtype
    hook: Callable = untimed
    graph: VCycleGraph | None = field(init=False, default=None, compare=False, repr=False)

    def __post_init__(self):
        mg = self.mg
        fine = getattr(mg.smoothers[-1], "inv_diag", None) if mg.n_levels > 1 else None
        object.__setattr__(self, "graph", VCycleGraph.prepare(
            self.graph_reason(), self._apply_in_place, fine, mg.operators[-1].dtype,
            self.outer_dtype,
        ))

    def graph_reason(self) -> str | None:
        """Why the application cannot be captured, or None."""
        mg = self.mg
        return static_reason((self.hook, mg.hook), (*mg.operators, *mg.transfers), mg.coarse_solve)

    def _apply_in_place(self, b_level: torch.Tensor) -> None:
        b_level.copy_(self.mg.vmult(b_level))

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        ph, top = self.hook, self.mg.n_levels - 1
        with span(PRECONDITION):
            if self.graph is not None and self.graph.takes(b):
                return self.graph.replay(b)
            b_level = ph("to_mg", top, b.to, self.mg.operators[-1].dtype)
            x = self.mg.vmult(b_level)
            return ph("to_global", top, x.to, self.outer_dtype)
