"""The one traffic generator: the problem a cell's solves are given, read
from ``traffic/<name>.json``.

A traffic file names the mesh (a family of ``mesh/generators.create`` with
its refinement) and the load mix: solve k takes b_k = alpha_k * b_constant
+ beta_k * b_gaussian, both loads scaled to unit norm.  The pairs come from
the seed as a two-dimensional Kronecker sequence (the plastic-number
lattice) with a seeded start, so that every seed spreads the same even
cover of the two ranges over the solves, in another order: any window's
solves see nearly the same mix of loads, and so nearly the same work.
"""

from __future__ import annotations

import json

import numpy as np

_PLASTIC = 1.324717957244746025960908854478097340734


def load(path: str) -> dict:
    with open(path) as f:
        t = json.load(f)
    for key in ("mesh", "loads", "check", "trace_solves", "n_dofs"):
        if key not in t:
            raise ValueError(f"{path}: no {key!r}")
    return t


def rng(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed, however large or negative."""
    s = int(seed)
    return np.random.default_rng([abs(s) & 0xFFFFFFFF, (abs(s) >> 32) & 0xFFFFFFFF, int(s < 0)])


class Loads:
    """The seed's load pairs: ``pair(k)`` for solve k of the window (k = -1
    is the warm-up's), and the solves whose answers are checked: the
    traffic's number of solves drawn from the seed among the window's first
    ``within``, and ``steady``, the one of those first solves whose load is
    nearest the Constant one (least |beta| / alpha), on which the check
    reads the V-cycle."""

    def __init__(self, traffic: dict, seed: int):
        g = rng(seed)
        self.start = g.random(2)
        self.alpha = traffic["loads"]["constant"]
        self.beta = traffic["loads"]["gaussian"]
        check = traffic["check"]
        within = int(check["within"])
        drawn = {int(i) for i in g.choice(within, int(check["solves"]), replace=False)}
        self.steady = min(range(within), key=lambda k: abs(self.pair(k)[1]) / self.pair(k)[0])
        self.checked = sorted(drawn | {self.steady})

    def pair(self, k: int) -> tuple[float, float]:
        u = (self.start + (k + 1) * np.array([1.0 / _PLASTIC, 1.0 / _PLASTIC**2])) % 1.0
        (a0, a1), (b0, b1) = self.alpha, self.beta
        return float(a0 + (a1 - a0) * u[0]), float(b0 + (b1 - b0) * u[1])
