"""Mesh generators for the benchmark geometries.

Behavioural mirrors of the reference's dealii::GridGenerator::create_*
(reference: include/grid_generator.h:3-141), which follow the mesh definitions
of Clevenger/Heister/Kanschat/Kronbichler (arXiv:1904.03317).  All meshes live
on the hypercube [-1, 1]^dim; local refinement flags feed
``AdaptiveMesh.refine`` which re-establishes 2:1 corner balance (the implicit
p4est behaviour the reference's cell counts depend on).
"""

from __future__ import annotations

import numpy as np

from .octree import AdaptiveMesh


def create_hypercube(dim: int, n_refinements: int) -> AdaptiveMesh:
    """Uniformly refined hypercube (reference: scripts/small-scaling-hypercube.py)."""
    mesh = AdaptiveMesh.unit(dim)
    mesh.refine_global(n_refinements)
    return mesh


def create_quadrant(dim: int, n_refinements: int) -> AdaptiveMesh:
    """Refine the all-negative quadrant/octant each step
    (reference: include/grid_generator.h:34-65)."""
    mesh = AdaptiveMesh.unit(dim)
    if n_refinements == 0:
        return mesh
    mesh.refine_global(1)
    for _ in range(1, n_refinements):
        flags = np.all(mesh.centers() < 0.0, axis=1)
        mesh.refine(flags)
    assert mesh.n_global_levels - 1 == n_refinements
    return mesh


def create_quadrant_flexible(dim: int, n_ref_global: int, n_ref_local: int) -> AdaptiveMesh:
    """n_ref_global uniform refinements followed by n_ref_local octant
    refinements (reference: include/grid_generator.h:69-92)."""
    mesh = AdaptiveMesh.unit(dim)
    mesh.refine_global(n_ref_global)
    for _ in range(n_ref_local):
        flags = np.all(mesh.centers() < 0.0, axis=1)
        mesh.refine(flags)
    return mesh


def create_circle(dim: int, n_refinements: int) -> AdaptiveMesh:
    """Refine cells with a vertex inside radius 1/(4*pi)
    (reference: include/grid_generator.h:3-30)."""
    mesh = AdaptiveMesh.unit(dim)
    mesh.refine_global(min(n_refinements, 3))
    for _ in range(3, n_refinements):
        vnorm = np.linalg.norm(mesh.vertices(), axis=2)
        flags = np.any(vnorm < 1.0 / (4.0 * np.pi), axis=1)
        mesh.refine(flags)
    assert mesh.n_global_levels - 1 == n_refinements
    return mesh


def create_annulus(dim: int, n_refinements: int) -> AdaptiveMesh:
    """Three nested radial-shell refinements on top of uniform refinement
    (reference: include/grid_generator.h:96-140)."""
    mesh = AdaptiveMesh.unit(dim)
    if n_refinements == 0:
        return mesh
    if n_refinements > 3:
        mesh.refine_global(n_refinements - 3)
    if n_refinements >= 1:
        r = np.linalg.norm(mesh.centers(), axis=1)
        mesh.refine(r < 0.55)
    if n_refinements >= 2:
        r = np.linalg.norm(mesh.centers(), axis=1)
        mesh.refine((0.3 <= r) & (r <= 0.43))
    if n_refinements >= 3:
        r = np.linalg.norm(mesh.centers(), axis=1)
        mesh.refine((0.335 <= r) & (r <= 0.39))
    return mesh


_GENERATORS = {
    "hypercube": lambda dim, g, l: create_hypercube(dim, g),
    "quadrant": lambda dim, g, l: create_quadrant(dim, g),
    "quadrant_flexible": create_quadrant_flexible,
    "circle": lambda dim, g, l: create_circle(dim, g),
    "annulus": lambda dim, g, l: create_annulus(dim, g),
}


def create(geometry_type: str, dim: int, n_ref_global: int, n_ref_local: int = 0) -> AdaptiveMesh:
    """Dispatch by GeometryType config key (reference: multigrid_throughput.cc:2048-2062)."""
    try:
        gen = _GENERATORS[geometry_type]
    except KeyError:
        raise ValueError(f"unknown GeometryType {geometry_type!r}") from None
    return gen(dim, n_ref_global, n_ref_local)
