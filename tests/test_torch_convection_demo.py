"""The port's convection demo against the JAX package's (CPU, float64).

The port repairs two faults of the JAX demo (the lattice origin and the
side-wall diffusion; the module docstring of
dealii_multigrid_tpu_torch/mantle_convection/demo.py), so whole runs differ
and are compared piece by piece: the lumped masses are equal, the trilinear
sampling agrees to 1e-15, and the Stokes solve of one buoyancy right-hand
side takes the JAX demo's FGMRES(60) count with x to 1e-8 once the JAX
velocity smoothers' Chebyshev intervals are copied in (the eigenvalue start
vectors differ).  Both faults are shown on the JAX demo's own tables; the
port's demo keeps T in [0, 1] with wT rising, also under a
temperature-dependent viscosity.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dealii_multigrid_tpu.solvers import gmres as JGM
from dealii_multigrid_tpu_torch.mantle_convection import demo as TD
from dealii_multigrid_tpu_torch.solvers import gmres as TGM

from test_torch_2d_solve import copy_intervals, rel

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "mantle_convection"))

import demo as JD  # noqa: E402


@pytest.fixture(scope="module")
def demos():
    return JD.build_convection_demo(2), TD.build_convection_demo(2, device="cpu")


def test_host_tables_and_sampling_match_jax(demos):
    jdemo, tdemo = demos
    assert (tdemo.n_v, tdemo.n_p) == (jdemo.n_v, jdemo.n_p)
    assert np.array_equal(tdemo.lump_v.numpy(), np.asarray(jdemo.lump_v))
    assert np.array_equal(tdemo.inv_lump_p.numpy(), np.asarray(jdemo.inv_lump_p))
    rng = np.random.default_rng(4)
    grid = rng.uniform(size=(5, 5, 5))
    pts = rng.uniform(-0.2, 2.2, size=(300, 3))  # clamping on both sides
    got = TD._trilinear(torch.as_tensor(grid), torch.as_tensor(pts), 0.5)
    assert rel(got, JD._trilinear(jnp.asarray(grid), jnp.asarray(pts), 0.5)) <= 1e-15


def test_stokes_solve_of_a_buoyancy_step_matches_jax(demos):
    jdemo, tdemo = demos
    vp = tdemo.precond.v_precond
    mg = dataclasses.replace(vp.mg, smoothers=copy_intervals(vp.mg.smoothers,
                                                             jdemo.precond.v_precond.mg.smoothers))
    tprec = dataclasses.replace(tdemo.precond, v_precond=dataclasses.replace(vp, mg=mg))
    rhs = tdemo.buoyancy_rhs(tdemo.T)
    tres = TGM.gmres_solve(tdemo.op.vmult, rhs, tprec.vmult, m=60, maxiter=400, reltol=1e-6)
    jres = jax.jit(lambda o, p, v: JGM.gmres_solve(o.vmult, v, p.vmult, m=60, maxiter=400,
                                                   reltol=1e-6))(jdemo.op, jdemo.precond,
                                                                 jnp.asarray(rhs.numpy()))
    assert tres.converged and bool(jres.converged)
    assert tres.n_iterations == int(jres.n_iterations)
    assert rel(tres.x, jres.x) <= 1e-8


def q1_stiffness(lat: np.ndarray, n1: int, h: float) -> sp.csr_matrix:
    """The unconstrained Q1 stiffness of the uniform lattice of cubes of side
    h, assembled with SciPy; ``lat`` [n, 3] the lattice index of each DoF."""
    K1 = np.array([[1.0, -1.0], [-1.0, 1.0]])
    M1 = np.array([[1.0, 0.5], [0.5, 1.0]]) / 3.0
    corners = np.array([(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)])
    Ke = np.zeros((8, 8))
    for d in range(3):
        mats = [K1 if e == d else M1 for e in range(3)]
        Ke += np.prod([mats[e][corners[:, None, e], corners[None, :, e]] for e in range(3)], axis=0)
    Ke *= h  # (1/h) h h: the stiffness of one axis times the masses of two
    dof = np.full((n1,) * 3, -1)
    dof[tuple(lat.T)] = np.arange(len(lat))
    cells = np.stack(np.meshgrid(*(np.arange(n1 - 1),) * 3, indexing="ij"), -1).reshape(-1, 3)
    cd = np.stack([dof[tuple((cells + c).T)] for c in corners], 1)  # [n_cells, 8]
    rows, cols = np.repeat(cd, 8, axis=1), np.tile(cd, (1, 8))
    return sp.csr_matrix((np.tile(Ke.reshape(-1), len(cd)), (rows.reshape(-1), cols.reshape(-1))),
                         shape=(len(lat), len(lat)))


def test_one_step_matches_an_independent_computation(demos):
    """One port step from the demo's initial temperature against the same
    step computed here from the JAX demo's node coordinates, moved to the
    mesh's lower corner: the initial profile, JAX's ``_trilinear`` on a
    lattice built from those coordinates, the buoyancy right-hand side,
    the time step, the departure points, the diffusion through a SciPy Q1
    stiffness with lumped masses counted per node, and the floor and lid.
    The velocity is the step's own (its solve is the test above)."""
    jdemo, tdemo = demos
    P, Q = np.asarray(jdemo.q1_pts), np.asarray(jdemo.q2_pts)
    lower, upper = P.min(axis=0), P.max(axis=0)
    n1 = len(np.unique(P[:, 0]))
    h = float(upper[0] - lower[0]) / (n1 - 1)
    x, z = (P[:, 0] - lower[0]) / (upper[0] - lower[0]), (P[:, 2] - lower[2]) / (upper[2] - lower[2])
    floor, lid = P[:, 2] == lower[2], P[:, 2] == upper[2]
    T0 = (1.0 - z) + 0.05 * np.cos(np.pi * x) * np.sin(np.pi * z)
    T0[floor], T0[lid] = 1.0, 0.0
    assert np.abs(tdemo.T.numpy() - T0).max() <= 1e-15

    lat = np.rint((P - lower) / h).astype(np.int64)
    grid = np.zeros((n1,) * 3)
    grid[tuple(lat.T)] = T0
    grid = jnp.asarray(grid)
    keep_z = np.asarray(jdemo.keep_v)[2 * tdemo.n_v:]
    fz = tdemo.Ra * np.asarray(JD._trilinear(grid, jnp.asarray(Q - lower), h)) * np.asarray(jdemo.lump_v) * keep_z
    rhs = np.concatenate([np.zeros(2 * tdemo.n_v), fz, np.zeros(tdemo.n_p)])
    assert rel(tdemo.buoyancy_rhs(tdemo.T), rhs) <= 1e-14

    T1, u, stats = tdemo.step(tdemo.T)
    g = TGM.gmres_solve(tdemo.op.vmult, torch.as_tensor(rhs), tdemo.precond.vmult, m=60, maxiter=400,
                        reltol=1e-6)
    assert g.n_iterations == stats["iterations"] and rel(u, g.x[: 3 * tdemo.n_v]) <= 1e-10
    u = u.numpy().reshape(3, tdemo.n_v)
    q2_of = {tuple(p): i for i, p in enumerate(np.rint((Q - lower) / (h / 2)).astype(np.int64))}
    u_q1 = u[:, [q2_of[tuple(2 * l)] for l in lat]].T  # [n_p, 3]: Q1 nodes are Q2 nodes
    umax = np.abs(u_q1).max()
    dt = min(tdemo.cfl * h / umax, 0.9 * h * h / (12.0 * tdemo.kappa))
    assert abs(float(stats["dt"]) - dt) <= 1e-15 * dt
    dep = np.clip(P - lower - dt * u_q1, 0.0, upper - lower)
    T_adv = np.asarray(JD._trilinear(grid, jnp.asarray(dep), h))
    cells_at = np.prod(1 + ((lat > 0) & (lat < n1 - 1)), axis=1)  # cells touching each node
    lumped = h**3 / 8.0 * cells_at
    T_new = T_adv - dt * tdemo.kappa * (q1_stiffness(lat, n1, h) @ T_adv) / lumped
    T_new[floor], T_new[lid] = 1.0, 0.0
    assert np.abs(T1.numpy() - T_new).max() <= 1e-12


def test_the_jax_demo_faults_and_their_repair(demos):
    jdemo, tdemo = demos
    # origin: JAX's lattice map folds the [-1, 1]^3 nodes and pins z <= 0
    # to the floor; the port's is a bijection with the floor at z = -1
    jlat = np.asarray(jdemo.q1_lat)
    assert len(np.unique(jlat)) < len(jlat)
    assert np.array_equal(np.sort(tdemo.q1_lat.numpy()), np.arange(tdemo.n_p))
    assert int(np.asarray(jdemo.bottom).sum()) == 75 and int(tdemo.bottom.sum()) == 25
    # diffusion: the constrained Laplacian moves a constant field on the
    # walls (its identity rows); the port's unconstrained apply does not
    ones = torch.ones(tdemo.n_p, dtype=torch.float64)
    walls = tdemo.lap_q1.dirichlet
    assert torch.equal(tdemo.lap_q1.vmult(ones)[walls], ones[walls])
    assert float(tdemo.lap_q1.cell_apply_raw(ones).abs().max()) <= 1e-14


def test_constant_viscosity_keeps_the_max_principle():
    demo, T, hist = TD.run_demo(r=3, n_steps=3, device="cpu")
    assert T.dtype == torch.float64 and T.device.type == "cpu"
    assert all(h["converged"] for h in hist)
    assert all(-1e-10 <= h["T_min"] and h["T_max"] <= 1 + 1e-10 for h in hist)
    assert hist[-1]["wT"] > hist[0]["wT"] > 0
    assert bool((T[demo.bottom] == 1).all()) and bool((T[demo.top] == 0).all())


def test_temperature_dependent_viscosity_step():
    eta_of_T = lambda T: 10.0 * np.exp(-3.0 * T)  # ~20x top-to-bottom
    demo, T, hist = TD.run_demo(r=2, n_steps=1, eta_of_T=eta_of_T, device="cpu")
    assert all(row["converged"] for row in hist)
    assert all(-1e-10 <= row["T_min"] and row["T_max"] <= 1 + 1e-10 for row in hist)
    scale = demo.op.a_op.scalar.scale
    assert float(scale.max() / scale.min()) > 5.0
