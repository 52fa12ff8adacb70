"""Boussinesq convection demo on the Taylor-Hood Stokes model, on torch.

Mirror of the JAX package's mantle_convection/demo.py.  The reference ships
mantle convection only as a README pointer to an external ASPECT fork
(reference: mantle-convection/README.md); this demo drives the port's
Stokes solver (models/stokes.py, or models/nsinker.py's rebuilder under a
temperature-dependent viscosity) through a small buoyancy-driven loop:

  1. buoyancy right-hand side f = (0, 0, Ra * T) lumped onto the Q2
     velocity space;
  2. the Stokes solve [[A, B^T], [B, 0]] (u, p) = (f, 0) by FGMRES with the
     block-triangular preconditioner, its true residual recomputed;
  3. semi-Lagrangian trilinear transport of the Q1 nodal temperature on the
     hypercube's regular node lattice (max-principle preserving by
     construction), plus explicit lumped-mass diffusion through the
     matrix-free Q1 Laplacian;
  4. the Dirichlet temperature re-imposed (hot floor T=1, cold lid T=0).

Two faults of the JAX package's demo are repaired here, so the port's
numbers differ from that demo's at every refinement:

  * origin: the JAX demo places the lattice, the floor, the lid and the
    initial profile at coordinate 0, but the hypercube spans [-1, 1]^3.
    Several Q1 nodes then share one lattice entry (its scatter keeps the
    last), advection samples a folded field, and every node with z <= 0 is
    pinned to the floor's T = 1.  The port measures all node coordinates
    from the mesh's lower corner: the lattice map is a bijection, so its
    writes have unique targets and a step is deterministic on the card;
  * diffusion: the JAX demo applies the Q1 Laplacian with its Dirichlet
    identity rows, so every side-wall node loses dt * kappa / m_i of its
    own value per step, which turns T negative on the walls once dt
    reaches its diffusion cap and m_i shrinks with h (r >= 3).  The port
    diffuses with the unconstrained (insulated-wall) Laplacian, whose rows
    sum to zero with non-positive couplings: under the step's dt cap each
    new value is a convex combination of old ones, and T stays in [0, 1].

The sums of the set-up (lumped masses) run on the host.

    python -m dealii_multigrid_tpu_torch.mantle_convection.demo [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..mesh import generators
from ..mesh.dof import make_hanging_node_constraints
from ..models.stokes import build_stokes, project_pressure_mean, triangular_preconditioner
from ..ops import tensor
from ..ops.operator import LaplaceOperator, make_operator
from ..solvers.gmres import gmres_solve, verify_true_residual
from ..utils.device import resolve_device
from ..utils.params import MultigridParameters


def _lattice_map(points: np.ndarray, h: float) -> tuple[np.ndarray, int]:
    """Map node coordinates on a regular lattice to flat indices; returns
    (DoF -> lattice flat index, nodes per axis)."""
    idx = np.rint(points / h).astype(np.int64)
    n = int(idx.max()) + 1
    return (idx[:, 0] * n + idx[:, 1]) * n + idx[:, 2], n


def _trilinear(grid: torch.Tensor, pts: torch.Tensor, h: float) -> torch.Tensor:
    """grid [N, N, N] nodal values (lattice spacing h, origin 0) sampled at
    pts [m, 3] with clamping (max-principle preserving)."""
    N = grid.shape[0]
    g = pts / h
    i0 = torch.clamp(torch.floor(g).to(torch.int64), 0, N - 2)
    f = torch.clamp(g - i0, 0.0, 1.0).to(grid.dtype)
    ix, iy, iz = i0[:, 0], i0[:, 1], i0[:, 2]
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]

    def at(dx, dy, dz):
        return grid[ix + dx, iy + dy, iz + dz]

    c00 = at(0, 0, 0) * (1 - fz) + at(0, 0, 1) * fz
    c01 = at(0, 1, 0) * (1 - fz) + at(0, 1, 1) * fz
    c10 = at(1, 0, 0) * (1 - fz) + at(1, 0, 1) * fz
    c11 = at(1, 1, 0) * (1 - fz) + at(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


@dataclass
class ConvectionDemo:
    op: object                # StokesOperator
    precond: object           # StokesTriangularPreconditioner
    lap_q1: LaplaceOperator   # Q1 Laplacian; its unconstrained apply diffuses
    T: torch.Tensor           # [n_p] nodal temperature (Q1)
    n_v: int
    n_p: int
    h: float
    N1: int                   # Q1 nodes per axis
    q1_lat: torch.Tensor      # [n_p] Q1 DoF -> lattice flat index (a bijection)
    q1_pts: torch.Tensor      # [n_p, 3]
    q2_pts: torch.Tensor      # [n_v, 3]
    lump_v: torch.Tensor      # [n_v] lumped Q2 mass
    inv_lump_p: torch.Tensor  # [n_p] inverse lumped Q1 mass
    keep_v: torch.Tensor      # [3 n_v]
    bottom: torch.Tensor      # [n_p] bool masks (z extremes)
    top: torch.Tensor
    Ra: float
    kappa: float
    cfl: float
    q2_at_q1: torch.Tensor    # [n_p] Q2 DoF at each Q1 node
    # temperature-dependent viscosity (optional): eta_of_T maps per-cell T
    # to per-cell viscosity; rebuild is models/nsinker.py's geometry-cached
    # viscosity swapper; p_cell_dofs is the Q1 cell -> DoF table
    eta_of_T: object = None
    rebuild: object = None
    p_cell_dofs: np.ndarray | None = None

    def _grid(self, T: torch.Tensor) -> torch.Tensor:
        g = T.new_zeros(self.N1**3)
        g[self.q1_lat] = T
        return g.view(self.N1, self.N1, self.N1)

    def _grid_from_q2(self, uc: torch.Tensor) -> torch.Tensor:
        # Q2 nodal values sampled onto the Q1 lattice: Q1 nodes are a subset
        # of Q2 nodes, selected by the precomputed map
        return self._grid(uc[self.q2_at_q1])

    def buoyancy_rhs(self, T: torch.Tensor) -> torch.Tensor:
        """The Stokes right-hand side of temperature T: (0, 0, Ra T) lumped
        onto the Q2 velocity space, zero on the Dirichlet rows and in the
        pressure block."""
        T_q2 = _trilinear(self._grid(T), self.q2_pts, self.h)
        fz = self.Ra * T_q2 * self.lump_v * self.keep_v[2 * self.n_v:]
        return torch.cat([T.new_zeros(2 * self.n_v), fz, T.new_zeros(self.n_p)])

    def step(self, T: torch.Tensor, maxiter: int = 400, rtol: float = 1e-6):
        """One Boussinesq step; returns (T_new, u, stats).  The stats' host
        seconds of the rebuild and of the Stokes solve end at a host read
        (the eigenvalue estimates, the true residual), so they include the
        device work."""
        t0 = time.perf_counter()
        # 0. temperature-dependent rheology: rebuild the viscous hierarchy
        # from the current T (cell-centre T = mean of the 8 Q1 corners, the
        # exact trilinear value)
        if self.eta_of_T is not None:
            T_cells = T.cpu().numpy()[self.p_cell_dofs].mean(axis=1)
            eta = np.asarray(self.eta_of_T(T_cells), np.float64)
            op, block = self.rebuild(eta)
            self.op = op
            self.precond = triangular_preconditioner(op, block)
        t1 = time.perf_counter()
        # 1. buoyancy right-hand side on the velocity space (z-component)
        rhs = self.buoyancy_rhs(T)
        # 2. Stokes solve, block-triangular FGMRES
        gres = gmres_solve(self.op.vmult, rhs, self.precond.vmult, m=60, maxiter=maxiter, reltol=rtol)
        verify_true_residual(self.op, rhs, gres.x, gres.residual_norm, rtol,
                             context="convection Stokes GMRES")
        t2 = time.perf_counter()
        x = project_pressure_mean(gres.x, self.n_v, self.n_p)
        u = x[: 3 * self.n_v]
        # 3. semi-Lagrangian advection on the Q1 lattice
        u_q1 = torch.stack([
            _trilinear(self._grid_from_q2(u[c * self.n_v:(c + 1) * self.n_v]), self.q1_pts, self.h)
            for c in range(3)
        ], dim=1)  # [n_p, 3]
        umax = u_q1.abs().max()
        dt = self.cfl * self.h / torch.clamp(umax, min=1e-12)
        # explicit-diffusion max-principle cap: lambda_max(M_L^-1 K) for Q1
        # on the uniform hypercube is ~12/h^2, and forward Euler preserves
        # positivity only up to dt = 1/(kappa lambda_max); slow flows (high
        # viscosity) would otherwise push the CFL dt past it
        dt = torch.clamp(dt, max=0.9 * self.h * self.h / (12.0 * self.kappa))
        dep = torch.clamp(self.q1_pts - dt * u_q1, 0.0, self.h * (self.N1 - 1))
        T_adv = _trilinear(self._grid(T), dep, self.h)
        # 4. explicit diffusion (lumped mass, insulated side walls) +
        # Dirichlet floor and lid
        T_new = T_adv - dt * self.kappa * self.inv_lump_p * self.lap_q1.cell_apply_raw(T_adv)
        T_new = T_new.masked_fill(self.top, 0.0).masked_fill(self.bottom, 1.0)
        stats = {
            "iterations": gres.n_iterations,
            "converged": gres.converged,
            "residual": gres.residual_norm,
            "umax": umax,
            "dt": dt,
            "rebuild_seconds": t1 - t0,
            "solve_seconds": t2 - t1,
        }
        return T_new, u, stats

    def run(self, T: torch.Tensor, n_steps: int):
        """``n_steps`` steps from T; returns (T, history), one dict of
        numbers per step."""
        history = []
        for _ in range(n_steps):
            T, u, stats = self.step(T)
            history.append({
                "iterations": int(stats["iterations"]),
                "converged": bool(stats["converged"]),
                "umax": float(stats["umax"]),
                "dt": float(stats["dt"]),
                "T_min": float(T.min()),
                "T_max": float(T.max()),
                # Nusselt-style proxy: mean vertical advective heat flux
                "wT": float(torch.mean(u[2 * self.n_v:3 * self.n_v][self.q2_at_q1] * T)),
                "rebuild_seconds": stats["rebuild_seconds"],
                "solve_seconds": stats["solve_seconds"],
            })
        return T, history


def _lumped_mass(dofh, degree: int, h3: np.ndarray) -> np.ndarray:
    """Row sums of the exact Q_degree element mass, assembled on the host."""
    row1 = tensor.mass_matrix_1d(degree).sum(axis=1)
    rows3 = np.kron(np.kron(row1, row1), row1)  # unit-cell row sums, x fastest
    lump = np.zeros(dofh.n_dofs)
    np.add.at(lump, dofh.cell_dofs.reshape(-1), (h3[:, None] * rows3[None, :]).reshape(-1))
    return lump


def build_convection_demo(
    r: int = 2, Ra: float = 1e3, kappa: float = 1e-2, cfl: float = 0.5,
    dtype: torch.dtype = torch.float64, eta_of_T=None,
    device: str | torch.device | None = None,
) -> ConvectionDemo:
    """The demo on the hypercube at refinement ``r`` on ``device`` (None: the
    card).  ``eta_of_T`` (optional): per-cell viscosity from per-cell
    temperature (e.g. the Frank-Kamenetskii law
    ``lambda T: eta0 * np.exp(-gamma * T)``); the viscous hierarchy is then
    rebuilt from T every step through models/nsinker.py's rebuilder."""
    from ..models.nsinker import make_stokes_rebuilder

    device = resolve_device(device)
    mesh = generators.create("hypercube", 3, r, 0)
    mg_data = MultigridParameters()
    mg_data.smoother.degree = 3
    rebuild = None
    if eta_of_T is None:
        op, block, aux = build_stokes(mesh, mg_data, dtype, device=device)
        dofh_v, dofh_p = aux["dofh_v"], aux["dofh_p"]
    else:
        rebuild = make_stokes_rebuilder(mesh, mg_data, dtype, device=device)
        dofh_v, dofh_p = rebuild.dofh_v, rebuild.dofh_p
        # initial build at unit viscosity; step() replaces it from T
        op, block = rebuild(np.ones(mesh.n_cells))
    h = float(mesh.h(int(mesh.level.max())))

    # node coordinates from the mesh's lower corner (module docstring)
    pts_p = dofh_p.points - np.asarray(mesh.lower, np.float64)
    pts_v = dofh_v.points - np.asarray(mesh.lower, np.float64)
    q1_lat, N1 = _lattice_map(pts_p, h)
    if N1**3 != dofh_p.n_dofs or len(np.unique(q1_lat)) != dofh_p.n_dofs:
        raise RuntimeError("the Q1 nodes do not fill the lattice one to one")
    # the Q2 DoF on each Q1 lattice node (the vertex subset)
    vert = np.full(N1**3, -1, np.int64)
    idx2 = np.rint(pts_v / (h / 2)).astype(np.int64)
    on_vertex = (idx2 % 2 == 0).all(axis=1)
    vi = idx2[on_vertex] // 2
    vert[(vi[:, 0] * N1 + vi[:, 1]) * N1 + vi[:, 2]] = np.nonzero(on_vertex)[0]
    if not (vert >= 0).all():
        raise RuntimeError("a Q1 lattice node carries no Q2 DoF")

    h3 = mesh.h(mesh.level) ** 3
    lump_v = _lumped_mass(dofh_v, 2, h3)
    lump_p = _lumped_mass(dofh_p, 1, h3)
    lap_q1 = make_operator(dofh_p, make_hanging_node_constraints(dofh_p), device, dtype)

    zmax = pts_p[:, 2].max()
    bottom = pts_p[:, 2] < 1e-12
    top = pts_p[:, 2] > zmax - 1e-12
    # initial temperature: conductive profile + a small symmetry-breaking
    # perturbation (the classic Rayleigh-Benard start)
    z = pts_p[:, 2] / zmax
    x_ = pts_p[:, 0] / zmax
    T0 = (1.0 - z) + 0.05 * np.cos(np.pi * x_) * np.sin(np.pi * z)
    T0[bottom] = 1.0
    T0[top] = 0.0

    def dev(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return ConvectionDemo(
        op=op,
        precond=triangular_preconditioner(op, block),
        lap_q1=lap_q1,
        T=dev(T0),
        n_v=dofh_v.n_dofs,
        n_p=dofh_p.n_dofs,
        h=h,
        N1=N1,
        q1_lat=dev(q1_lat, torch.int64),
        q1_pts=dev(pts_p),
        q2_pts=dev(pts_v),
        lump_v=dev(lump_v),
        inv_lump_p=dev(1.0 / lump_p),
        keep_v=op.keep_v,
        bottom=dev(bottom, torch.bool),
        top=dev(top, torch.bool),
        Ra=Ra,
        kappa=kappa,
        cfl=cfl,
        q2_at_q1=dev(vert[q1_lat], torch.int64),
        eta_of_T=eta_of_T,
        rebuild=rebuild,
        p_cell_dofs=np.asarray(dofh_p.cell_dofs),
    )


def run_demo(r: int = 2, n_steps: int = 3, **kw):
    """``n_steps`` steps from the demo's initial temperature; returns
    (demo, T, history)."""
    demo = build_convection_demo(r, **kw)
    T, history = demo.run(demo.T, n_steps)
    return demo, T, history


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    _, _, hist = run_demo(device=args.device)
    for i, row in enumerate(hist):
        print(i, row)


if __name__ == "__main__":
    main()
