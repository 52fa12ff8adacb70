"""The plain reference against the port on the CPU at small sizes: the same
mesh, the same constrained loads, and the port's solution meets the
configuration's tolerance under the reference's operator."""

import numpy as np
import pytest
import torch

from reference import poisson_q as pq


@pytest.mark.parametrize("family,r", [("quadrant", 2), ("quadrant", 4), ("quadrant", 5),
                                      ("hypercube", 3), ("circle", 4), ("annulus", 4)])
def test_mesh_equals_the_ports(family, r):
    from dealii_multigrid_tpu_torch.mesh import generators

    mine = pq.build_mesh(family, r)
    port = generators.create(family, 3, r)
    a = set(zip(mine.level.tolist(), map(tuple, mine.anchor.tolist())))
    b = set(zip(port.level.tolist(), map(tuple, port.anchor.tolist())))
    assert a == b


def _port(family, r, simulation_type):
    from dealii_multigrid_tpu_torch import api
    from dealii_multigrid_tpu_torch.utils.params import RunParameters

    prm = RunParameters()
    prm.type, prm.geometry_type, prm.n_ref_global = "HMG-global", family, r
    prm.number_type, prm.mg_number_type = "double", "float"
    prm.simulation_type = simulation_type
    prm.mg_data.smoother.degree, prm.mg_data.n_repetitions = 3, 1
    res, prob, levels = api.run(prm, "cpu")
    return res, prob, levels[-1]


@pytest.mark.parametrize("family,r", [("quadrant", 3), ("hypercube", 2)])
def test_loads_and_solution_against_the_port(family, r):
    P = pq.PoissonQ(pq.build_mesh(family, r), 4, "cpu")
    for st in ("Constant", "Gaussian"):
        res, prob, fine = _port(family, r, st)
        index = P.node_index(fine.dofh.points)
        b_ref = P.load(st)
        b_port = torch.as_tensor(P.take(index, prob.rhs.double().numpy()))
        assert float(torch.linalg.vector_norm(b_port - b_ref) / torch.linalg.vector_norm(b_ref)) < 1e-12
        x = res.x.double().numpy()
        h = prob.hanging
        if len(h.slave):
            x[h.slave] = (h.weights * x[h.masters]).sum(axis=1)
        r_ = b_ref - P.apply(torch.as_tensor(P.take(index, x)))
        assert float(torch.linalg.vector_norm(r_) / torch.linalg.vector_norm(b_ref)) <= 1e-4


def test_operator_is_symmetric_and_positive():
    P = pq.PoissonQ(pq.build_mesh("quadrant", 3), 2, "cpu")
    g = torch.Generator().manual_seed(0)
    u, v = (torch.randn(P.n_free, generator=g, dtype=torch.float64) for _ in range(2))
    au, av = P.apply(u), P.apply(v)
    assert abs(float(torch.dot(v, au) - torch.dot(u, av))) < 1e-12 * float(torch.dot(u, au))
    assert float(torch.dot(u, au)) > 0


def test_hanging_values_interpolate_a_quadratic_exactly():
    # a Q2 function on the quadrant mesh: the nodal values of a global
    # quadratic are consistent across hanging faces
    P = pq.PoissonQ(pq.build_mesh("quadrant", 3), 2, "cpu")
    pts = torch.as_tensor(P.node_points())
    f = (1 - pts[:, 0] ** 2) * (1 - pts[:, 1] ** 2) * (1 - pts[:, 2] ** 2)
    u = f.clone()
    u[P._hang] = 0.0
    P._distribute(u)
    assert float((u - f).abs().max()) < 1e-13
