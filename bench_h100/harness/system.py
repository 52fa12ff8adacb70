"""The system under test: the port's hierarchy for one configuration and
mesh, built by the port's own set-up functions in the order
``dealii_multigrid_tpu_torch.api`` composes them, and its solve.

A solve is one call of the port's CG on the outer operator's ``vmult`` and
``dot``, preconditioned by ``PreconditionMG`` (HMG-global, PMG, HPMG) or
``PreconditionLS`` (HMG-local, HPMG-local), from x0 = 0 to the
configuration's tolerance: the ``solve()`` closure of ``api.mg_solve``
without its warm-up, repetitions and guard.  The port functions called are
listed in PERF.md (section 3); a change beneath them is what the
benchmark sees.

Wired: the Types HMG-global, PMG, HPMG, HMG-local and HPMG-local in 3D on
the hybrid engine, with the outer number types double, float, mixed and
df32 over double, float or bfloat16 levels; the benchmark's tests rehearse
each on the CPU against the reference.  AMG, AMGPETSc and 2D are refused.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

GC_TYPES = ("HMG-global", "PMG", "HPMG")
LS_TYPES = ("HMG-local", "HPMG-local")


class FirstApply:
    """The preconditioner as the CG sees it; when armed it keeps the first
    output of the next solve (z0 = M^-1 b, what the V-cycle computed)."""

    def __init__(self, inner):
        self.inner = inner
        self.armed = False
        self.first = None

    def vmult(self, b):
        z = self.inner.vmult(b)
        if self.armed:
            self.first, self.armed = z, False
        return z


@dataclasses.dataclass
class Entry:
    """An operator of the solve path as the stencil kernel sees it."""

    op: object
    per_iteration: int          # applications per CG iteration
    dtype: torch.dtype

    @property
    def degree(self) -> int:
        return self.op.n1 - 1


class System:
    """One configuration's hierarchy on ``device``; ``spans`` holds the
    fenced set-up spans (seconds) the per-layer metrics read."""

    def __init__(self, params, device: torch.device):
        from dealii_multigrid_tpu_torch import api
        from dealii_multigrid_tpu_torch.mesh import generators
        from dealii_multigrid_tpu_torch.mesh.coarsening import (
            geometric_coarsening_sequence,
            polynomial_coarsening_sequence,
        )
        from dealii_multigrid_tpu_torch.solvers.local_smoothing import (
            build_local_smoothing_mg_hybrid,
        )

        if params.dim != 3 or params.type not in GC_TYPES + LS_TYPES:
            raise ValueError(
                f"the harness drives the hybrid engine in 3D; Type {params.type!r} "
                f"in {params.dim}D is not wired"
            )
        if params.n_shards > 1:
            raise ValueError("the harness drives one device (NShards 1)")
        self.params, self.device = params, device
        self.spans: dict = {}
        outer_dtype = api.number_dtype(params.number_type)
        level_dtype = api.number_dtype(params.mg_number_type)
        self.df32 = params.number_type == "df32"
        fence = lambda: torch.cuda.synchronize(device) if device.type == "cuda" else None  # noqa: E731

        t0 = time.perf_counter()
        mesh = generators.create(
            params.geometry_type, params.dim, params.n_ref_global, params.n_ref_local
        )
        if params.type in GC_TYPES:
            tri_seq = geometric_coarsening_sequence(mesh, params.min_level, params.min_n_cells)
            plan = api.gc_level_plan(params.type, tri_seq, params.fe_degree_fine)
            levels = [
                api.build_level_hybrid(m, d, device, level_dtype) for m, d in plan
            ]
            fine = levels[-1]
        else:
            fine = api.build_level_hybrid(mesh, params.fe_degree_fine, device, level_dtype)
            levels = [fine]
        fence()
        t1 = time.perf_counter()
        self.outer_op, self._loads = self._outer_and_loads(api, params, fine, device)
        fence()
        t2 = time.perf_counter()
        mg = lsmg = None
        if params.type in GC_TYPES:
            mg = api.build_gc_preconditioner_hybrid(levels, params.mg_data)
            precond = api.PreconditionMG(mg, outer_dtype)
        elif params.type == "HMG-local":
            lsmg = build_local_smoothing_mg_hybrid(
                fine.dofh, fine.fmt, params.mg_data, device, level_dtype,
                max(params.min_level, 0),
            )
            precond = api.PreconditionLS(lsmg, fine.op.constrained_keep, outer_dtype)
        else:  # HPMG-local
            degrees = polynomial_coarsening_sequence(params.fe_degree_fine, "bisect")
            plevels = [
                fine if d == params.fe_degree_fine
                else api.build_level_hybrid(mesh, d, device, level_dtype)
                for d in degrees
            ]
            lsmg = build_local_smoothing_mg_hybrid(
                plevels[0].dofh, plevels[0].fmt, params.mg_data, device, level_dtype,
                max(params.min_level, 0),
            )
            ls_precond = api.PreconditionLS(lsmg, plevels[0].op.constrained_keep, level_dtype)
            mg = api.build_gc_preconditioner_hybrid(plevels, params.mg_data, coarse_solve=ls_precond)
            precond = api.PreconditionMG(mg, outer_dtype)
        fence()
        t3 = time.perf_counter()
        self.spans = {"hierarchy_s": t1 - t0, "loads_s": t2 - t1, "precond_s": t3 - t2}
        self.fine, self.levels, self.mg, self.lsmg = fine, levels, mg, lsmg
        self.precond = precond
        self.wrapper = FirstApply(precond)
        self.n_dofs = fine.dofh.n_dofs
        self.entries = self._entries(outer_dtype)

    # ------------------------------------------------------------ set-up
    def _outer_and_loads(self, api, params, fine, device):
        """The outer operator (``api._outer_problem``) and the two loads,
        Constant and Gaussian, each assembled as ``_outer_problem`` assembles
        its right-hand side and scaled to unit norm (float64)."""
        from dealii_multigrid_tpu_torch.models import poisson
        from dealii_multigrid_tpu_torch.ops.hybrid import make_hybrid_operator
        from dealii_multigrid_tpu_torch.ops.hybrid_format import cell_slot_table

        const = dataclasses.replace(params, simulation_type="Constant")
        outer_op, rhs_c, problem = api._outer_problem(const, fine, device)
        if params.number_type in ("mixed", "df32"):
            rhs_op = make_hybrid_operator(fine.fmt, fine.hanging, device, torch.float64)
        else:
            rhs_op = outer_op
        _, rhs_g = poisson.assemble_problem_hybrid(
            fine.dofh, fine.hanging, rhs_op, cell_slot_table(fine.fmt), fine.fmt, "Gaussian"
        )
        del rhs_op
        if self.df32:
            rhs_c = rhs_c.hi.double() + rhs_c.lo.double()
        loads = []
        for r in (rhs_c, rhs_g):
            r = r.double()
            loads.append(r / torch.sqrt(torch.sum(r * fine.op.owner.double() * r)))
        self.hanging = problem.hanging
        return outer_op, loads

    def _entries(self, outer_dtype) -> list:
        """Stencil applications per CG iteration: the outer
        vmult once; each global-coarsening level above the coarsest 2 x the
        smoother degree per visit (degree - 1 pre-smoothing, 1 residual,
        degree post-smoothing); each local-smoothing level above its
        coarsest 2 x degree + 2 (the two interface operators besides)."""
        deg = self.params.mg_data.smoother.degree
        outer = self.outer_op
        inner = getattr(outer, "op", outer)  # mixed wraps the float32 operator
        out = [Entry(inner, 1, inner.dtype)]
        if self.mg is not None:
            ops = self.mg.operators
            out += [Entry(op, 2 * deg, op.dtype) for op in ops[1:]]
        if self.lsmg is not None:
            out += [Entry(lv.op, 2 * deg + 2, lv.op.dtype) for lv in self.lsmg.levels[1:]]
        return [e for e in out if getattr(e.op, "NP", 0) > 0]

    # ------------------------------------------------------------- solve
    def rhs(self, alpha: float, beta: float):
        """b = alpha * b_constant + beta * b_gaussian in the outer type."""
        from dealii_multigrid_tpu_torch.solvers import twofloat

        b = alpha * self._loads[0] + beta * self._loads[1]
        if self.df32:
            return twofloat.tf_split_f64_host(b)
        return b.to(self.outer_op.dtype)

    def solve(self, b, precond=None):
        """One solve from x0 = 0; returns the port's CG result."""
        from dealii_multigrid_tpu_torch.solvers import twofloat
        from dealii_multigrid_tpu_torch.solvers.cg import cg_solve

        ctrl = self.params.mg_data.cg_normal
        pre = (precond or self.wrapper).vmult
        op = self.outer_op
        if self.df32:
            return twofloat.cg_solve_df32(
                op.vmult, b, preconditioner=pre, maxiter=ctrl.maxiter,
                abstol=ctrl.abstol, reltol=ctrl.reltol, weight=op.owner,
                allsum=getattr(op, "allsum", None),
            )
        return cg_solve(
            op.vmult, b, preconditioner=pre, maxiter=ctrl.maxiter,
            abstol=ctrl.abstol, reltol=ctrl.reltol, dot=op.dot,
        )

    def instrumented(self, recorder):
        """The preconditioner wrapper around a copy whose V-cycle phases run
        through ``recorder`` (utils/phases.instrument)."""
        from dealii_multigrid_tpu_torch.utils.phases import instrument

        return FirstApply(instrument(self.precond, recorder))

    def to_host(self, v) -> np.ndarray:
        """A slot vector as float64 global DoF values on the host, the
        hanging DoFs distributed from their masters."""
        from dealii_multigrid_tpu_torch.solvers import twofloat

        if isinstance(v, twofloat.TF):
            v = v.hi.double() + v.lo.double()
        u = self.fine.to_global(v).double().cpu().numpy()
        h = self.hanging
        if len(h.slave):
            u[h.slave] = (h.weights * u[h.masters]).sum(axis=1)
        return u

    def points(self) -> np.ndarray:
        return self.fine.dofh.points
