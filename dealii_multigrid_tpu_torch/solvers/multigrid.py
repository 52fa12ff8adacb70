"""Multigrid V-cycle and the preconditioner wrapper.

Mirror of deal.II's Multigrid + PreconditionMG as the reference's mg_solve
drives them (multigrid_throughput.cc:1093-1133): per-level Chebyshev pre-
and post-smoothing, residual restriction, coarse solve, prolongation, and
the precision boundary between the outer Krylov solve and the MG levels.

Every phase runs through the object's ``hook`` (``hook(phase, fn, *args)``
returns ``fn(*args)``), the analog of the reference's Multigrid signals
(multigrid_throughput.cc:1152-1234).  The default hook only calls; the
profiled solve of ``ProfilePhases`` runs a copy whose hook times each phase
(utils/phases.py), so the timed solves carry no event and no branch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def untimed(phase: str, fn: Callable, *args):
    """The default phase hook: apply the phase, time nothing."""
    return fn(*args)


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
            return ph("cs", self.coarse_solve, b)
        sm = self.smoothers[level]
        tr = self.transfers[level]
        x = ph("pre", sm.vmult, b)                                 # zero initial guess
        r = ph("residuum", residual, self.operators[level], b, x)
        bc = ph("res", tr.restrict, r)
        xc = self._v_cycle(level - 1, bc)                          # coarse correction
        x = ph("pro", prolong_add, tr, x, xc)
        return ph("post", sm.step, x, b)

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        """Apply as a preconditioner: one V-cycle from a zero guess."""
        return self._v_cycle(self.n_levels - 1, b)


@dataclass(frozen=True)
class PreconditionMG:
    """Precision boundary between the outer Krylov solve and the MG levels
    (reference: float MG levels under a double outer CG,
    multigrid_throughput.cc:528-550); the two casts are the phases
    ``to_mg`` and ``to_global``."""

    mg: Multigrid
    outer_dtype: torch.dtype
    hook: Callable = untimed

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        ph = self.hook
        b_level = ph("to_mg", b.to, self.mg.operators[-1].dtype)
        x = self.mg.vmult(b_level)
        return ph("to_global", x.to, self.outer_dtype)
