"""Multigrid V-cycle and the preconditioner wrapper.

Mirror of deal.II's Multigrid + PreconditionMG as the reference's mg_solve
drives them (multigrid_throughput.cc:1093-1133): per-level Chebyshev pre-
and post-smoothing, residual restriction, coarse solve, prolongation, and
the precision boundary between the outer Krylov solve and the MG levels.

Every phase runs through the object's ``hook`` (``hook(phase, level, fn,
*args)`` returns ``fn(*args)``; level 0 is the coarsest), the analog of the
reference's Multigrid signals (multigrid_throughput.cc:1152-1234): by
default ``untimed``, in the profiled solve and in debug mode a copy's
recorder or check (utils/phases.py), so the timed solves carry no event, no
check and no branch.  Built on a CUDA device, ``PreconditionMG`` replays
its application as one CUDA graph (solvers/vcycle_graph.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

import torch

# finite_check, debug mode's hook, is named here beside the default one
from ..utils.phases import PRECONDITION, finite_check, span, untimed  # noqa: F401
from .vcycle_graph import GraphedApplication, VCycle, VCycleGraph


def residual(op, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return b - op.vmult(x)


def prolong_add(transfer, x: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    return x + transfer.prolong(xc)


@dataclass(frozen=True)
class Multigrid(VCycle):
    """V(1,1)-cycle over a level hierarchy (coarsest = index 0)."""

    operators: tuple
    smoothers: tuple        # smoothers[0] unused (None)
    transfers: tuple        # transfers[l]: level l <-> l-1; transfers[0] None
    coarse_solve: object    # called as coarse_solve(b)
    hook: Callable = untimed

    @property
    def n_levels(self) -> int:
        return len(self.operators)

    def parts(self) -> tuple:
        return (*self.operators, *self.transfers)

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
class PreconditionMG(GraphedApplication):
    """Precision boundary between the outer Krylov solve and the MG levels
    (reference: float MG levels under a double outer CG,
    multigrid_throughput.cc:528-550); the two casts are the phases
    ``to_mg`` and ``to_global``.  On a CUDA device the whole application
    is one CUDA graph (solvers/vcycle_graph.py)."""

    mg: Multigrid
    outer_dtype: torch.dtype
    hook: Callable = untimed
    graph: VCycleGraph | None = field(init=False, default=None, compare=False, repr=False)

    def __post_init__(self):
        mg = self.mg
        fine = getattr(mg.smoothers[-1], "inv_diag", None) if mg.n_levels > 1 else None
        self._prepare(fine, mg.operators[-1].dtype)

    def graph_reason(self) -> str | None:
        return "hook" if self.hook is not untimed else self.mg.graph_reason()

    def _hooked(self, hook: Callable) -> "PreconditionMG":
        return dataclasses.replace(self, mg=self.mg.with_hook(hook), hook=hook)

    def _apply(self, b_level: torch.Tensor) -> torch.Tensor:
        return self.mg.vmult(b_level)

    def _eager(self, b: torch.Tensor) -> torch.Tensor:
        ph, top = self.hook, self.mg.n_levels - 1
        with span(PRECONDITION):
            b_level = ph("to_mg", top, b.to, self.mg.operators[-1].dtype)
            x = self.mg.vmult(b_level)
            return ph("to_global", top, x.to, self.outer_dtype)
