"""Multigrid V-cycle and the preconditioner wrapper.

Mirror of deal.II's Multigrid + PreconditionMG as the reference's mg_solve
drives them (multigrid_throughput.cc:1093-1133): per-level Chebyshev pre-
and post-smoothing, residual restriction, coarse solve, prolongation, and
the precision boundary between the outer Krylov solve and the MG levels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Multigrid:
    """V(1,1)-cycle over a level hierarchy (coarsest = index 0)."""

    operators: tuple
    smoothers: tuple        # smoothers[0] unused (None)
    transfers: tuple        # transfers[l]: level l <-> l-1; transfers[0] None
    coarse_solve: object    # called as coarse_solve(b)

    @property
    def n_levels(self) -> int:
        return len(self.operators)

    def _v_cycle(self, level: int, b: torch.Tensor) -> torch.Tensor:
        if level == 0:
            return self.coarse_solve(b)
        sm = self.smoothers[level]
        op = self.operators[level]
        tr = self.transfers[level]
        x = sm.vmult(b)                       # pre-smooth (zero initial guess)
        r = b - op.vmult(x)                   # residual
        bc = tr.restrict(r)                   # restrict
        xc = self._v_cycle(level - 1, bc)     # coarse correction
        x = x + tr.prolong(xc)                # prolongate
        return sm.step(x, b)                  # post-smooth

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        """Apply as a preconditioner: one V-cycle from a zero guess."""
        return self._v_cycle(self.n_levels - 1, b)


@dataclass(frozen=True)
class PreconditionMG:
    """Precision boundary between the outer Krylov solve and the MG levels
    (reference: float MG levels under a double outer CG,
    multigrid_throughput.cc:528-550)."""

    mg: Multigrid
    outer_dtype: torch.dtype

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        level_dtype = self.mg.operators[-1].dtype
        return self.mg.vmult(b.to(level_dtype)).to(self.outer_dtype)
