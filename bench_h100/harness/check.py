"""The comparison that decides ``correct``.

Once the window has closed, the plain reference (``reference/``) rebuilds
the discrete problem from the mesh description and the load pairs, and
judges the sampled solves of the window by what they say: those drawn from
the seed among its first solves, the steady one, and the window's last
solve, so that a fault that sets in only after many solves shows too:

* ``true_residual``: ||b - A x|| / ||b|| of the solve's answer x, with the
  reference's A and b in float64, the largest over the sampled solves.  Its
  limit is the configuration's own RelativeTolerance.  It covers the outer
  operator, the constraints and the CG.
* ``residual_gap``: |true_residual - the residual the CG reported| of each
  sampled solve, the largest: the answer is what the solver says it is, to
  the precision of the configuration's outer number type (a float32 outer
  CG reaches the tolerance too, but its answer parts from its own residual
  by float32 rounding).
* ``first_step_residual``: ||b - a A z|| / ||b|| with z = M^-1 b, the
  preconditioner's first output inside the steady solve (the checked solve
  whose load is nearest the Constant one), and a = (b.z) / (z.A z): the
  residual after the CG's first step.  It measures the V-cycle the timed
  path ran (smoothers, eigenvalue intervals, transfers, coarse solve, level
  operators), which x alone does not show at this tolerance.  It is read on
  one load shape because it depends on the load: a larger Gaussian share
  gives a larger first step on every V-cycle.
* ``unconverged``: solves of the window whose CG did not converge (limit 0).

Limits other than the tolerance come from the readings in
``limits/<cell>.json``.
"""

from __future__ import annotations

import importlib
import os
import sys
from dataclasses import dataclass

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Sample:
    index: int          # the solve's place in the window
    alpha: float
    beta: float
    x: np.ndarray       # global DoF values, hanging DoFs distributed
    z: np.ndarray | None  # the preconditioner's first output, likewise (steady solve)
    claimed: float      # the CG's own final residual / ||b||
    steady: bool        # the solve the V-cycle is read on


def reference_module(name: str):
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    return importlib.import_module(f"reference.{name}")


class Referee:
    """The plain reference's problem for one mesh and degree, and its two
    unit loads, built once; ``read`` judges sampled solves."""

    def __init__(self, ref_name: str, mesh: dict, degree: int, device):
        ref = reference_module(ref_name)
        self.problem = ref.PoissonQ(
            ref.build_mesh(mesh["GeometryType"], int(mesh["NRefGlobal"]), int(mesh.get("NRefLocal", 0))),
            degree, device,
        )
        self.loads = []
        for kind in ("Constant", "Gaussian"):
            b = self.problem.load(kind)
            self.loads.append(b / torch.linalg.vector_norm(b))

    def read(self, points: np.ndarray, samples: list) -> dict:
        """{"true_residual": .., "residual_gap": .., "first_step_residual": ..}
        of the samples: the largest over them, the V-cycle's on the steady
        one."""
        P = self.problem
        if getattr(self, "_points", None) is not points:
            self._points, self._index = points, P.node_index(points)
        index = self._index
        out = {"true_residual": 0.0, "residual_gap": 0.0, "first_step_residual": float("nan")}
        for s in samples:
            b = s.alpha * self.loads[0] + s.beta * self.loads[1]
            nb = torch.linalg.vector_norm(b)
            x = torch.as_tensor(P.take(index, s.x), device=P.device)
            res = float(torch.linalg.vector_norm(b - P.apply(x)) / nb)
            out["true_residual"] = max(out["true_residual"], res)
            out["residual_gap"] = max(out["residual_gap"], abs(res - s.claimed))
            if s.steady:
                z = torch.as_tensor(P.take(index, s.z), device=P.device)
                az = P.apply(z)
                a = torch.dot(b, z) / torch.dot(z, az)
                out["first_step_residual"] = float(torch.linalg.vector_norm(b - a * az) / nb)
        return out


def judge(readings: dict, limits: dict, unconverged: int) -> tuple[bool, dict]:
    """``correct`` and, per number, its value beside its limit."""
    table = {name: {"value": readings[name], "limit": limits[name]} for name in limits}
    table["unconverged"] = {"value": unconverged, "limit": 0}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
