"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing falls back to the CPU):
  1. set up: require a CUDA card, keep float32 contractions out of TF32;
  2. build the patch-stencil kernel from dealii_multigrid_tpu_torch/csrc;
  3. check the kernel against its plain PyTorch version on the card, in
     float32 and float64: S in {9, 17, 33} x NP in {1, 8, 512}; the six
     (NP, S) shapes of the main path; each degree p in {1, 2, 3, 4, 8} with
     band p at S = 8p + 1; random KS, MS zero outside a band b < 8 at
     S = 33.  Time the kernel (CUDA events) at the six main-path shapes in
     float32 and at (512, 33) in float64, and the plain version at
     (512, 33) float32, and compute each shape's bound;
  4. solve, each path through api.run on cuda:0 with the launch count set
     to 0 just before it and read just after:
     a. a small double-precision HMG-global solve on the card against the
        same solve on the CPU (plain stencil path);
     b. the main path: HMG-global quadrant r=7 p=4 (17,551,967 DoFs, float
        levels, Chebyshev degree 3, CG to rtol 1e-4), 5 repetitions; checks
        convergence in 3 iterations, the recomputed-residual guard, and that
        every patch apply went through the kernel;
     c. card against CPU, small: PMG and HPMG at r=3 p=4 in double (x to
        1e-8), HMG-global and HPMG at r=3 p=2 in mixed and df32 (x to 1e-5),
        equal iteration counts;
     d. HPMG quadrant r=7 p=4 (10 levels), NumberType mixed, float levels,
        5 repetitions: converged, guard, one iteration count in all 6
        solves, launches as expected;
     e. df32 on the hierarchy of d: within one iteration of d, x within
        1e-5 relative of d's;
     f. PMG quadrant r=5 p=4 mixed (3 levels, dense coarse solve on the
        fine mesh at p=1): converged, launches as expected;
     g. card against CPU, small, local smoothing: HMG-local and HPMG-local
        at r=3 p=4 in double (x to 1e-8), at r=3 p=2 in mixed and df32
        over float levels (x to 1e-5), equal iteration counts;
     h. HMG-local quadrant r=7 p=4 (17,551,967 DoFs, 8 levels), NumberType
        double, float levels, 5 repetitions: 4 iterations in all six
        solves, the guard, launches as expected;
     i. HPMG-local quadrant r=7 p=4 (10 levels: p = 4, 2 on the active
        mesh above the degree-1 LS hierarchy), double over float, 5
        repetitions: converged, one iteration count in all solves, the
        guard, launches as expected;
     j. card against CPU, small, double, with a coarse solve that is
        really AMG: truncated HPMG at r=4 p=4 (MinLevel 5 leaves the fine
        mesh at p = 1, 2, 4; the coarse level has 1,008 DoFs) with the coarse
        types amg, amg_petsc (2 cycles), cg_with_amg, cg and
        cg_with_chebyshev, and the solver types AMG and AMGPETSc at r=4 p=2;
        x to 1e-8, equal iteration counts.  The direct-solve limit
        ``solvers.coarse.DIRECT_SOLVER_MAX_DOFS`` is lowered to 300 for this
        comparison only (at the first mesh above the real limit, r=6, the
        CPU side would take minutes);
     k. PMG quadrant r=7 p=4 (17,551,967 DoFs; p = 4, 2, 1 on the fine
        mesh, smoothed-aggregation AMG on 283,109 DoFs), NumberType mixed,
        float levels, coarse type amg, 5 repetitions: converged, the guard,
        one iteration count in all six solves, launches as expected; prints
        the AMG hierarchy and the set-up split;
     l. on k's hierarchy: coarse types cg_with_amg, and amg_petsc with 2
        cycles: converged, one iteration count in all solves;
     m. HPMG quadrant r=6 p=4, MinLevel 7, double over float levels: amg
        with 1-4 cycles and amg_petsc with 2, beside the records' iteration
        counts (results/parameters-hp-amg-trunc-tpu-part2.txt, -part3.txt);
        fails on a row that did not converge;
     n. AMG and AMGPETSc on quadrant r=7 p=1 (283,109 DoFs), double;
     o. the CLI on two JSON files written to a temporary directory
        (HMG-global r=7 p=4 float, and k's configuration, both with
        ProfilePhases): two table rows with every column, and the phase sum
        times the iteration count against the solve time (printed; held to
        PHASE_SUM_LIMIT times it, see there);
  5. for every patch level of the b, d, f, h, i and k hierarchies (h and i
     through ``result.mg`` and ``result.ls_mg``): the kernel on the level's
     own KS, MS and pscale against the plain version, its time, launches
     per solve and bound; then the kernels line, the card's name and power
     limit, and the result line.

The expected launch counts come from the same per-level entries
(``gc_entries``, ``ls_entries``) that step 5 reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

F32_RTOL, F32_ATOL_REL = 2e-5, 2e-4   # f32: atol = 2e-4 * max|ref|
F64_REL = 1e-12                        # f64: max|err| / max|ref|
TIMED_LAUNCHES = 50
#: (NP, S) of the patch levels L7..L2 of quadrant r=7 p=4, finest first
MAIN_SHAPES = ((512, 33), (64, 33), (8, 33), (8, 17), (27, 9), (8, 9))
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP32 and FP64 (non-tensor) peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_params(n_ref: int, degree: int, number: str, reps: int,
                 mg_type: str = "HMG-global", mg_number: str | None = None,
                 coarse: str = "amg", n_cycles: int = 1, min_level: int = -1):
    from dealii_multigrid_tpu_torch.utils.params import RunParameters

    prm = RunParameters()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = n_ref
    prm.fe_degree_fine = degree
    prm.min_level = min_level
    prm.number_type = number
    prm.mg_number_type = mg_number or number
    prm.mg_data.coarse_solver.type = coarse
    prm.mg_data.coarse_solver.n_cycles = n_cycles
    prm.mg_data.smoother.degree = 3
    prm.mg_data.cg_normal.reltol = 1e-4
    prm.mg_data.n_repetitions = reps
    return prm


def time_ms(fn, n: int) -> float:
    """Device time per call: n calls queued behind a sleep kernel run back to
    back, so host launch overhead does not enter; CUDA events around them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than enqueuing n calls
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def assembled(p: int, S: int, dtype, dev):
    from dealii_multigrid_tpu_torch.ops import tensor
    from dealii_multigrid_tpu_torch.ops.hybrid_format import _assembled_1d

    K = (S - 1) // p
    return tuple(
        torch.as_tensor(_assembled_1d(m(p), K, p), dtype=dtype, device=dev)
        for m in (tensor.stiffness_matrix_1d, tensor.mass_matrix_1d)
    )


def bound(NP: int, S: int, KS: torch.Tensor, MS: torch.Tensor, dtype) -> tuple[float, str]:
    """Least time (ms) for the function on these inputs: bytes (read u, KS,
    MS, pscale once, write out once) over HBM bandwidth, or the band's
    operations (2 per nonzero coefficient per line: KS in 3 and MS in 4 of
    the 7 axis contractions, plus the scale) over the FP peak."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * NP * S**3 + 2 * S * S + NP) * size
    nnz_k, nnz_m = int((KS != 0).sum()), int((MS != 0).sum())
    flops = NP * (2 * S * S * (3 * nnz_k + 4 * nnz_m) + S**3)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(dev: torch.device) -> dict:
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    rng = np.random.default_rng(0)
    measured = {"max_abs_err": 0.0, "shapes": {}}

    def compare(what, dtype, NP, S, KS, MS, band):
        xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
        sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
        got = ps.patch_stencil(xp, KS, MS, sc, band)
        ref = ps.patch_stencil_reference(xp, KS, MS, sc)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rmax = float(ref.abs().max())
        if dtype == torch.float32:
            ok = bool(torch.all((got - ref).abs() <= F32_ATOL_REL * rmax + F32_RTOL * ref.abs()))
        else:
            ok = err <= F64_REL * rmax
        name = "f32" if dtype == torch.float32 else "f64"
        print(f"kernel check {what} {name} NP={NP} S={S} band={band}: max_abs_err={err:.3e} "
              f"max|ref|={rmax:.3e} ok={ok}", flush=True)
        check(ok, f"patch stencil kernel disagrees with the plain version ({what} {name} NP={NP} S={S})")
        if dtype == torch.float32 and what == "main-path":
            measured["max_abs_err"] = max(measured["max_abs_err"], err)

    for dtype in (torch.float32, torch.float64):
        for S in (9, 17, 33):
            KS, MS = assembled(4, S, dtype, dev)
            for NP in (1, 8, 512):
                compare("grid", dtype, NP, S, KS, MS, 4)
        for NP, S in MAIN_SHAPES:
            KS, MS = assembled(4, S, dtype, dev)
            compare("main-path", dtype, NP, S, KS, MS, 4)
        for p in (1, 2, 3, 4, 8):
            S = 8 * p + 1
            KS, MS = assembled(p, S, dtype, dev)
            compare(f"degree p={p}", dtype, 8, S, KS, MS, p)
        S = 33
        i, j = np.indices((S, S))
        for b in (1, 2, 3, 5, 7):
            KS, MS = (
                torch.as_tensor(np.where(abs(i - j) <= b, rng.standard_normal((S, S)), 0.0),
                                dtype=dtype, device=dev)
                for _ in range(2)
            )
            check(ps.matrix_band(KS.cpu(), MS.cpu()) == b, f"random band {b}")
            compare(f"random band b={b}", dtype, 8, S, KS, MS, b)

    # timings: every main-path shape in float32, the finest also in float64
    for dtype, shapes in ((torch.float32, MAIN_SHAPES), (torch.float64, MAIN_SHAPES[:1])):
        for NP, S in shapes:
            KS, MS = assembled(4, S, dtype, dev)
            xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
            sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
            b_ms, b_by = bound(NP, S, KS, MS, dtype)
            kern = lambda: ps.patch_stencil(xp, KS, MS, sc, 4)  # noqa: E731
            if (dtype, NP, S) == (torch.float32, 512, 33):
                # plain, kernel, kernel, plain: compare within one call
                plain = lambda: ps.patch_stencil_reference(xp, KS, MS, sc)  # noqa: E731
                t_plain = [time_ms(plain, TIMED_LAUNCHES)]
                t_kern = [time_ms(kern, TIMED_LAUNCHES), time_ms(kern, TIMED_LAUNCHES)]
                t_plain.append(time_ms(plain, TIMED_LAUNCHES))
                measured["plain_ms"] = min(t_plain)
                print(f"stencil NP=512 S=33 f32: kernel {t_kern} ms, plain {t_plain} ms "
                      f"(each the mean of {TIMED_LAUNCHES} launches)", flush=True)
            else:
                t_kern = [time_ms(kern, TIMED_LAUNCHES), time_ms(kern, TIMED_LAUNCHES)]
            ms = min(t_kern)
            measured["shapes"][(dtype, NP, S)] = (ms, b_ms, b_by)
            name = "f32" if dtype == torch.float32 else "f64"
            print(f"stencil timing {name} NP={NP} S={S}: {ms:.6f} ms (runs {t_kern}), bound "
                  f"{1e3 * b_ms:.2f} us ({b_by}), roofline share {b_ms / ms:.4f}", flush=True)
    ms, b_ms, b_by = measured["shapes"][(torch.float32, 512, 33)]
    measured.update(ms=ms, bound_ms=b_ms, bound_by=b_by)
    return measured


class Entry(NamedTuple):
    """One operator of a solve path, as the stencil launches it."""

    label: str
    op: object                  # HybridOperator
    per_iteration: int          # launches per CG iteration
    dtype: torch.dtype          # dtype of those launches
    setup: int                  # launches of the eigenvalue estimate


def gc_entries(levels, prm) -> list:
    """Entries of a global-coarsening hierarchy, finest first: each V-cycle
    visit of a level above the coarsest launches 2 * degree times (degree - 1
    in the pre-smoother, 1 residual, degree in the post-smoother), the finest
    once more for the outer vmult (the mixed and df32 outer operator is the
    fine level's float32 operator); the eigenvalue estimate runs
    eig_cg_n_iterations vmults on each."""
    deg = prm.mg_data.smoother.degree
    eig = prm.mg_data.smoother.eig_cg_n_iterations
    return [
        Entry(f"L{l} p={levels[l].degree}", levels[l].op,
              2 * deg + (1 if l == len(levels) - 1 else 0), levels[l].op.dtype, eig)
        for l in range(len(levels) - 1, 0, -1)
    ]


def ls_entries(result, fine, outer_dtype, prm) -> list:
    """Entries of an LS path, finest first: the outer operator (the fine
    level's tables, applied in ``outer_dtype``) once per iteration; the
    p-levels above the LS hierarchy (HPMG-local) 2 * degree per visit; every
    LS level above its coarsest 2 * degree + 2 per visit (interface_down and
    interface_up besides the smoother and residual).  Levels above each
    hierarchy's coarsest run the eigenvalue estimate."""
    deg = prm.mg_data.smoother.degree
    eig = prm.mg_data.smoother.eig_cg_n_iterations
    p_ops = result.mg.operators if result.mg is not None else []
    ls_levels = result.ls_mg.levels
    out = [Entry(f"outer p={fine.degree}", fine.op, 1, outer_dtype, 0)]
    out += [Entry(f"p={p_ops[l].n1 - 1}", p_ops[l], 2 * deg, p_ops[l].dtype, eig)
            for l in range(len(p_ops) - 1, 0, -1)]
    out += [Entry(f"LS L{l}", ls_levels[l].op, 2 * deg + 2, ls_levels[l].op.dtype, eig)
            for l in range(len(ls_levels) - 1, 0, -1)]
    return out


def expected_launches(entries, iterations, setup: bool = True) -> int:
    """Stencil launches a solve path implies: an operator with patches
    launches once per vmult.  Each CG iteration the entries' launches per
    iteration; the eigenvalue estimates (``setup``); one vmult of the finest
    entry for the residual guard; none for the "Constant" RHS."""
    live = [e for e in entries if e.op.NP > 0]
    n = sum(iterations) * sum(e.per_iteration for e in live)
    if setup:
        n += sum(e.setup for e in live)
    return n + (1 if entries[0].op.NP > 0 else 0)


def counted(fn):
    """Run fn with the launch count set to 0 just before; (result, launches)."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    torch.cuda.synchronize()
    ps.launches.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, ps.launches.count


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def check_solve(name: str, result, entries, launches: int, n_it: int | None = None,
                setup: bool = True, extra_launches: int = 0) -> None:
    """The checks every full-size path makes, and its line of numbers.
    ``extra_launches``: launches the entries do not describe (a coarse CG on
    the coarsest level's operator), counted by the caller."""
    expect = expected_launches(entries, result.solve_iterations, setup) + extra_launches
    its = result.solve_iterations
    print(f"{name}: operators (label, NP, S, band, launches per iteration) "
          f"{[(e.label, e.op.NP, e.op.S, e.op.band, e.per_iteration) for e in entries]}",
          flush=True)
    print(f"{name}: solve iterations {its}; loop residual {result.residual_norm:.4e}, "
          f"true residual {result.true_residual:.4e} (allowance {result.guard_threshold:.4e}); "
          f"stencil launches {launches} (expected {expect})", flush=True)
    check(result.converged, f"{name} did not converge")
    check(len(set(its)) == 1, f"{name}: the solves took different iteration counts {its}")
    if n_it is not None:
        check(its[0] == n_it, f"{name}: expected {n_it} CG iterations, got {its}")
    check(result.true_residual <= result.guard_threshold, f"{name}: true-residual guard failed")
    check(launches > 0 and launches == expect, f"{name}: stencil launches {launches} != expected {expect}")
    check("jax" not in sys.modules, "the port imported jax")
    x = result.x
    check(x.shape == (result.n_dofs,) and bool(torch.isfinite(x).all()),
          f"{name}: the solution is not a finite vector of n_dofs values")


def check_levels(name: str, entries, iterations: int, card: str, rng) -> None:
    """Each patch level's own KS, MS and pscale through the kernel against the
    plain version (the level's dtype and float64), its time with CUDA events
    in the dtype the solve launches it in, and launches per solve (of
    ``iterations`` CG iterations) x time against the bound."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    total = 0.0
    for label, op, per_iteration, run_dtype, _ in entries:
        if op.NP == 0:
            continue
        n = per_iteration * iterations
        for dtype in (op.dtype, torch.float64):
            KS, MS, sc = (t.to(dtype).contiguous() for t in (op.KS, op.MS, op.pscale))
            xp = torch.as_tensor(rng.standard_normal((op.NP, op.S**3)), dtype=dtype, device=op.device)
            got = ps.patch_stencil(xp, KS, MS, sc, op.band)
            ref = ps.patch_stencil_reference(xp, KS, MS, sc)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rmax = float(ref.abs().max())
            if dtype == torch.float32:
                ok = bool(torch.all((got - ref).abs() <= F32_ATOL_REL * rmax + F32_RTOL * ref.abs()))
            else:
                ok = err <= F64_REL * rmax
            tag = "f32" if dtype == torch.float32 else "f64"
            print(f"{name} {label} kernel check {tag} NP={op.NP} S={op.S} band={op.band}: "
                  f"max_abs_err={err:.3e} max|ref|={rmax:.3e} ok={ok}", flush=True)
            check(ok, f"{name} {label}: the kernel disagrees with the plain version ({tag})")
        KS, MS, sc = (t.to(run_dtype).contiguous() for t in (op.KS, op.MS, op.pscale))
        xp = torch.as_tensor(rng.standard_normal((op.NP, op.S**3)), dtype=run_dtype, device=op.device)
        kern = lambda: ps.patch_stencil(xp, KS, MS, sc, op.band)  # noqa: E731
        ms = min(time_ms(kern, TIMED_LAUNCHES), time_ms(kern, TIMED_LAUNCHES))
        b_ms, b_by = bound(op.NP, op.S, KS, MS, run_dtype)
        total += n * ms
        tag = "f32" if run_dtype == torch.float32 else "f64"
        print(f"{name} {label} {tag} NP={op.NP} S={op.S} band={op.band}: {n} launches "
              f"per solve x {ms:.6f} ms = {n * ms:.4f} ms; bound {1e3 * b_ms:.2f} us ({b_by}), "
              f"roofline share {b_ms / ms:.4f}; card {card}", flush=True)
    print(f"{name}: stencil per solve {total:.4f} ms of kernel time; card {card}", flush=True)


class CountingOp:
    """An operator that counts its vmults (the coarse CG's, which launch the
    stencil once each on a level with patches)."""

    def __init__(self, op):
        self.op = op
        self.calls = 0

    def vmult(self, x):
        self.calls += 1
        return self.op.vmult(x)

    def dot(self, x, y):
        return self.op.dot(x, y)


def amg_of(solver):
    """The AMGPreconditioner inside a coarse solver; fails where there is none."""
    from dealii_multigrid_tpu_torch.solvers.coarse import find_amg

    amg = find_amg(solver)
    check(amg is not None, f"no AMG inside {type(solver).__name__}")
    return amg


def print_amg(name: str, amg, card: str) -> None:
    rows = amg.describe()
    print(f"{name}: AMG hierarchy, finest first (rows, widest row of A / P / P^T, MiB of "
          f"device tables, omega) "
          f"{[(d['rows'], d['K_A'], d['K_P'], d['K_PT'], round(d['bytes'] / 2**20, 2), round(d['omega'], 4)) for d in rows]}; "
          f"dense coarsest factor {tuple(amg.chol.shape)} {amg.chol.dtype}, "
          f"{amg.chol.numel() * amg.chol.element_size() / 2**20:.1f} MiB; tables "
          f"{sum(d['bytes'] for d in rows) / 2**20:.1f} MiB; cycles {amg.n_cycles}; set-up seconds "
          f"{ {k: round(v, 3) for k, v in amg.setup_seconds.items()} }; card {card}", flush=True)


#: Phase o holds (sum of the MG phases) x iterations to this multiple of the
#: solve time.  The phases of one V-cycle should add up to less than a CG
#: iteration; but the solve time is the best of five on a host whose speed
#: moves by tens of percent within seconds, and the phases are timed after
#: it, so the ratio read 0.85-1.52 over the runs of scripts/probe_phases.py
#: and of this script.  The line prints the ratio and whether it was below 1.
PHASE_SUM_LIMIT = 2.0

#: the CLI's columns with ProfilePhases and Verbosity on, in order
CLI_COLUMNS = (
    "dim type geometry n_cells degree n_ref_global n_ref_local min_level coarse_type n_cycles "
    "smoother_deg reltol number mg_number policy n_cells_hn n_cells_n n_dofs n_levels "
    "sub_comm_size n_iterations converged time time_per_it time_cg throughput time_pre "
    "time_residuum time_res time_cs time_pro time_edge_pro time_post time_to_mg time_to_global "
    "workload_eff workload_path_max workload_path_max_node vertical_eff horizontal_eff mem_total"
).split()


def parse_last_table(text: str) -> list:
    """Rows (dicts) of the last table in the CLI's output; cells are cut at
    the header's column offsets, so an empty cell stays empty."""
    lines = text.splitlines()
    top = max(i for i, ln in enumerate(lines) if ln.startswith("dim "))
    header = lines[top]
    names = header.split()
    starts, pos = [], 0
    for nm in names:
        pos = header.index(nm, pos)
        starts.append(pos)
        pos += len(nm)
    ends = starts[1:] + [None]
    return [
        {nm: ln[a:b].strip() for nm, a, b in zip(names, starts, ends)}
        for ln in lines[top + 1:] if ln.strip()
    ]



def main() -> int:
    # 1. set up
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a CUDA card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    from dealii_multigrid_tpu_torch import api
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps
    from dealii_multigrid_tpu_torch.solvers import twofloat
    from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} ({card})",
          flush=True)

    # 2. build
    secs = ps.build()
    print(f"kernel build: {secs:.1f} s -> {ps.library.path}", flush=True)
    if ps.library.build_log.strip():
        print(ps.library.build_log.strip(), flush=True)

    # 3. kernel against the plain version
    measured = check_kernel(dev)
    rng = np.random.default_rng(1)

    # 4a. small solve on the card against the same solve on the CPU
    small = bench_params(3, 2, "double", 1)
    res_gpu, _, _ = api.run(small, dev)
    res_cpu, _, _ = api.run(small, "cpu")
    rel = max_rel(res_gpu.x, res_cpu.x)
    print(f"small solve r=3 p=2 double: card {res_gpu.n_iterations} it, cpu {res_cpu.n_iterations} it, "
          f"max rel diff {rel:.3e}", flush=True)
    check(res_gpu.n_iterations == res_cpu.n_iterations and rel <= 1e-8,
          "card solve disagrees with the CPU solve at r=3 p=2")

    # 4b. the main path: quadrant r=7 p=4, float, 5 repetitions
    prm = bench_params(7, 4, "float", 5)
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (result, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    wall = time.perf_counter() - t0
    paths = {"hmg_global_r7_float": launches}
    print(f"levels (NP, S, NS, use_cross): {[(lv.op.NP, lv.op.S, lv.op.NS, lv.op.use_cross) for lv in levels]}",
          flush=True)
    entries = gc_entries(levels, prm)
    check_solve("HMG-global r=7 float", result, entries, launches, n_it=3)
    print(f"HMG-global quadrant r=7 p=4 float: n_dofs {result.n_dofs}, iterations {result.n_iterations}, "
          f"solve {result.time:.6f} s (reps {[round(t, 6) for t in result.time_per_rep]}), "
          f"{result.throughput / 1e6:.3f} MDoF/s, setup {result.setup_time:.1f} s, "
          f"run wall {wall:.1f} s, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)

    # 5 (main path). per patch level: kernel time x launches per solve against the bound
    shapes = [(e.op.NP, e.op.S) for e in entries if e.op.NP > 0]
    check(shapes == list(MAIN_SHAPES), f"patch level shapes {shapes} != {MAIN_SHAPES}")
    check(all(lv.op.band == 4 for lv in levels), "an operator's band is not p = 4")
    total = 0.0
    for label, op, per_iteration, _, _ in entries:
        if op.NP == 0:
            continue
        n = per_iteration * result.n_iterations
        ms, b_ms, b_by = measured["shapes"][(torch.float32, op.NP, op.S)]
        total += n * ms
        print(f"{label} NP={op.NP} S={op.S}: {n} launches per solve x {ms:.6f} ms = {n * ms:.4f} ms; "
              f"bound {1e3 * b_ms:.2f} us ({b_by}), roofline share {b_ms / ms:.4f}; card {card}",
              flush=True)
    print(f"stencil per solve: {total:.4f} ms of kernel time; card {card}", flush=True)
    # release every reference to the hierarchy: the next phases' peaks
    # must not include it
    del result, _problem, levels, entries, op
    torch.cuda.empty_cache()

    # 4c. card against CPU, small: PMG and HPMG in double, mixed and df32
    for mg_type, r, p, number, mg_number, tol in (
        ("PMG", 3, 4, "double", "double", 1e-8),
        ("HPMG", 3, 4, "double", "double", 1e-8),
        ("HMG-global", 3, 2, "mixed", "float", 1e-5),
        ("HMG-global", 3, 2, "df32", "float", 1e-5),
        ("HPMG", 3, 2, "mixed", "float", 1e-5),
        ("HPMG", 3, 2, "df32", "float", 1e-5),
    ):
        small = bench_params(r, p, number, 1, mg_type, mg_number)
        res_gpu, _, _ = api.run(small, dev)
        res_cpu, _, _ = api.run(small, "cpu")
        rel = max_rel(res_gpu.x, res_cpu.x)
        print(f"small solve {mg_type} r={r} p={p} {number}/{mg_number}: card {res_gpu.n_iterations} it, "
              f"cpu {res_cpu.n_iterations} it, max rel diff {rel:.3e} (limit {tol:g})", flush=True)
        check(res_gpu.n_iterations == res_cpu.n_iterations and rel <= tol
              and res_gpu.x.dtype == res_cpu.x.dtype,
              f"card solve disagrees with the CPU solve ({mg_type} r={r} p={p} {number})")

    # 4d. HPMG quadrant r=7 p=4, mixed outer CG around float levels
    prm = bench_params(7, 4, "mixed", 5, "HPMG", "float")
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (res_m, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    wall = time.perf_counter() - t0
    paths["hpmg_r7_mixed"] = launches
    check(len(levels) == 10 and [lv.degree for lv in levels[-3:]] == [1, 2, 4],
          f"HPMG r=7 p=4 plan: {[(lv.degree, lv.mesh.n_cells) for lv in levels]}")
    entries = gc_entries(levels, prm)
    check_solve("HPMG r=7 mixed", res_m, entries, launches)
    print(f"HPMG quadrant r=7 p=4 mixed/float: n_dofs {res_m.n_dofs}, levels {len(levels)}, "
          f"iterations {res_m.n_iterations} (records: 4 at r=4-6), solve {res_m.time:.6f} s "
          f"(reps {[round(t, 6) for t in res_m.time_per_rep]}), {res_m.throughput / 1e6:.3f} MDoF/s, "
          f"setup {res_m.setup_time:.1f} s, run wall {wall:.1f} s, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)

    # 4e. df32 on the same hierarchy: the f64 RHS split exactly into a pair
    fine = levels[-1]
    b_pair = twofloat.tf_split_f64_host(res_m.rhs_used)
    # the peak of the solve phase alone (d's peak includes its set-up)
    torch.cuda.reset_peak_memory_stats()
    res_d, launches = counted(lambda: api.mg_solve(
        fine.op, b_pair, PreconditionMG(res_m.mg, torch.float32), prm.mg_data,
        n_levels=len(levels), n_dofs=fine.dofh.n_dofs,
    ))
    paths["hpmg_r7_df32"] = launches
    res_d.x = fine.to_global(res_d.x)
    check_solve("HPMG r=7 df32", res_d, entries, launches, setup=False)
    rel = norm_rel(res_d.x, res_m.x)
    print(f"HPMG quadrant r=7 p=4 df32/float on the same hierarchy: iterations {res_d.n_iterations} "
          f"(mixed {res_m.n_iterations}), x vs mixed {rel:.3e} relative, solve {res_d.time:.6f} s "
          f"(reps {[round(t, 6) for t in res_d.time_per_rep]}), {res_d.throughput / 1e6:.3f} MDoF/s, "
          f"peak mem of the solves with the hierarchy held "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}", flush=True)
    check(abs(res_d.n_iterations - res_m.n_iterations) <= 1 and rel <= 1e-5,
          "df32 disagrees with mixed on the HPMG r=7 hierarchy")
    check_levels("HPMG r=7", entries, res_m.n_iterations, card, rng)
    del res_m, res_d, b_pair, fine, _problem, levels, entries
    torch.cuda.empty_cache()

    # 4f. PMG quadrant r=5 p=4 mixed: dense coarse solve on the fine mesh at p=1
    prm = bench_params(5, 4, "mixed", 5, "PMG", "float")
    (res_p, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    paths["pmg_r5_mixed"] = launches
    entries = gc_entries(levels, prm)
    check_solve("PMG r=5 mixed", res_p, entries, launches)
    print(f"PMG quadrant r=5 p=4 mixed/float: n_dofs {res_p.n_dofs}, levels {len(levels)}, coarse "
          f"{levels[0].dofh.n_dofs} DoFs, iterations {res_p.n_iterations} (record: 4), "
          f"solve {res_p.time:.6f} s, {res_p.throughput / 1e6:.3f} MDoF/s, setup {res_p.setup_time:.1f} s; "
          f"card {card}", flush=True)
    check_levels("PMG r=5", entries, res_p.n_iterations, card, rng)
    del res_p, _problem, levels, entries
    torch.cuda.empty_cache()

    # 4g. card against CPU, small: HMG-local and HPMG-local
    for mg_type, r, p, number, mg_number, tol in (
        ("HMG-local", 3, 4, "double", "double", 1e-8),
        ("HPMG-local", 3, 4, "double", "double", 1e-8),
        ("HMG-local", 3, 2, "mixed", "float", 1e-5),
        ("HMG-local", 3, 2, "df32", "float", 1e-5),
        ("HPMG-local", 3, 2, "mixed", "float", 1e-5),
        ("HPMG-local", 3, 2, "df32", "float", 1e-5),
    ):
        small = bench_params(r, p, number, 1, mg_type, mg_number)
        res_gpu, _, _ = api.run(small, dev)
        res_cpu, _, _ = api.run(small, "cpu")
        rel = max_rel(res_gpu.x, res_cpu.x)
        print(f"small solve {mg_type} r={r} p={p} {number}/{mg_number}: card {res_gpu.n_iterations} it, "
              f"cpu {res_cpu.n_iterations} it, max rel diff {rel:.3e} (limit {tol:g})", flush=True)
        check(res_gpu.n_iterations == res_cpu.n_iterations and rel <= tol
              and res_gpu.x.dtype == res_cpu.x.dtype,
              f"card solve disagrees with the CPU solve ({mg_type} r={r} p={p} {number})")

    # 4h, 4i. HMG-local and HPMG-local quadrant r=7 p=4, double over float
    # (the records' configuration: results/small-scaling-quadrant-tpu-merged.txt:23)
    for key, mg_type, n_levels, n_it in (
        ("hmg_local_r7", "HMG-local", 8, 4),
        ("hpmg_local_r7", "HPMG-local", 10, None),
    ):
        prm = bench_params(7, 4, "double", 5, mg_type, "float")
        before = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (res, _problem, levels), launches = counted(lambda: api.run(prm, dev))
        wall = time.perf_counter() - t0
        paths[key] = launches
        ls_levels = res.ls_mg.levels
        print(f"{mg_type} r=7: LS levels (n_dofs, NP, S, NS, band) "
              f"{[(lv.fmt.dofh.n_dofs, lv.op.NP, lv.op.S, lv.op.NS, lv.op.band) for lv in ls_levels]}",
              flush=True)
        check(res.n_dofs == 17_551_967 and res.n_levels == n_levels,
              f"{mg_type} r=7: {res.n_dofs} DoFs, {res.n_levels} levels")
        check(all(lv.op.band == lv.fmt.dofh.degree for lv in ls_levels),
              f"{mg_type} r=7: an LS level's band is not its degree")
        entries = ls_entries(res, levels[0], torch.float64, prm)
        check_solve(f"{mg_type} r=7", res, entries, launches, n_it=n_it)
        print(f"{mg_type} quadrant r=7 p=4 double/float: n_dofs {res.n_dofs}, levels {res.n_levels}, "
              f"iterations {res.n_iterations} (records: 4), solve {res.time:.6f} s "
              f"(reps {[round(t, 6) for t in res.time_per_rep]}), {res.throughput / 1e6:.3f} MDoF/s, "
              f"setup {res.setup_time:.1f} s, run wall {wall:.1f} s, "
              f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)
        check_levels(f"{mg_type} r=7", entries, res.n_iterations, card, rng)
        del res, _problem, levels, ls_levels, entries
        torch.cuda.empty_cache()

    # 4j. card against CPU, small, double, the coarse solve really AMG
    from dealii_multigrid_tpu_torch import cli
    from dealii_multigrid_tpu_torch.solvers import coarse as coarse_mod

    real_limit = coarse_mod.DIRECT_SOLVER_MAX_DOFS
    coarse_mod.DIRECT_SOLVER_MAX_DOFS = 300
    print(f"phase j: solvers.coarse.DIRECT_SOLVER_MAX_DOFS lowered from {real_limit} to 300 for "
          "this comparison, so that the 1,008-DoF coarse level gets a multi-level AMG", flush=True)
    try:
        for mg_type, r, p, coarse, n_cycles, min_level in (
            ("HPMG", 4, 4, "amg", 1, 5),
            ("HPMG", 4, 4, "amg_petsc", 2, 5),
            ("HPMG", 4, 4, "cg_with_amg", 1, 5),
            ("HPMG", 4, 4, "cg", 1, 5),
            ("HPMG", 4, 4, "cg_with_chebyshev", 1, 5),
            ("AMG", 4, 2, "amg", 1, -1),
            ("AMGPETSc", 4, 2, "amg", 1, -1),
        ):
            small = bench_params(r, p, "double", 1, mg_type, "double", coarse, n_cycles, min_level)
            res_gpu, _, lv_gpu = api.run(small, dev)
            res_cpu, _, _ = api.run(small, "cpu")
            rel = max_rel(res_gpu.x, res_cpu.x)
            solver = res_gpu.amg if res_gpu.mg is None else res_gpu.mg.coarse_solve
            amg = amg_of(solver) if coarse not in ("cg", "cg_with_chebyshev") else None
            n_amg = len(amg.levels) if amg is not None else 0
            print(f"small solve {mg_type} r={r} p={p} coarse {coarse} x{n_cycles} MinLevel {min_level}: "
                  f"levels {res_gpu.n_levels}, coarse level {lv_gpu[0].dofh.n_dofs} DoFs, AMG levels "
                  f"{n_amg}, card {res_gpu.n_iterations} it, cpu {res_cpu.n_iterations} it, "
                  f"max rel diff {rel:.3e} (limit 1e-08)", flush=True)
            check(res_gpu.converged and res_gpu.n_iterations == res_cpu.n_iterations and rel <= 1e-8,
                  f"card solve disagrees with the CPU solve ({mg_type} coarse {coarse})")
            check(amg is None or n_amg >= 2, f"{mg_type} coarse {coarse}: the coarse solve is not AMG")
    finally:
        coarse_mod.DIRECT_SOLVER_MAX_DOFS = real_limit
    del res_gpu, res_cpu, lv_gpu, solver, amg
    torch.cuda.empty_cache()

    # 4k. PMG quadrant r=7 p=4 mixed over float levels, AMG on the fine mesh at p=1
    prm = bench_params(7, 4, "mixed", 5, "PMG", "float")
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (res_k, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    wall = time.perf_counter() - t0
    paths["pmg_r7_mixed_amg"] = launches
    check([lv.degree for lv in levels] == [1, 2, 4] and levels[0].dofh.n_dofs == 283_109
          and res_k.n_dofs == 17_551_967,
          f"PMG r=7 p=4 plan: {[(lv.degree, lv.dofh.n_dofs) for lv in levels]}")
    entries = gc_entries(levels, prm)
    check_solve("PMG r=7 mixed amg", res_k, entries, launches)
    amg_k = amg_of(res_k.mg.coarse_solve)
    check(len(amg_k.levels) >= 2 and amg_k.levels[0].A.shape[0] == 283_109,
          "PMG r=7: the coarse solve is not AMG on the p=1 fine mesh")
    print_amg("PMG r=7", amg_k, card)
    print(f"PMG quadrant r=7 p=4 mixed/float coarse amg: n_dofs {res_k.n_dofs}, levels {len(levels)}, "
          f"coarse {levels[0].dofh.n_dofs} DoFs, iterations {res_k.n_iterations}, solve {res_k.time:.6f} s "
          f"(reps {[round(t, 6) for t in res_k.time_per_rep]}), {res_k.throughput / 1e6:.3f} MDoF/s, "
          f"setup {res_k.setup_time:.1f} s, run wall {wall:.1f} s, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)
    check_levels("PMG r=7", entries, res_k.n_iterations, card, rng)

    # 4l. other coarse types on k's hierarchy (the outer operator, the
    # right-hand side, transfers and smoothers are k's)
    fine = levels[-1]
    outer_op = api.MixedPrecisionOperator(fine.op)
    prm_l = bench_params(7, 4, "mixed", 2, "PMG", "float", n_cycles=2)
    for kind in ("cg_with_amg", "amg_petsc"):
        t0 = time.perf_counter()
        coarse = api._hybrid_coarse_solver(kind, levels[0], prm_l.mg_data)
        counter = None
        if kind == "cg_with_amg":
            counter = CountingOp(coarse.op)
            coarse = dataclasses.replace(coarse, op=counter)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        print_amg(f"PMG r=7 coarse {kind}", amg_of(coarse), card)
        mg_l = dataclasses.replace(res_k.mg, coarse_solve=coarse)
        res_l, launches = counted(lambda: api.mg_solve(
            outer_op, res_k.rhs_used, PreconditionMG(mg_l, torch.float64), prm_l.mg_data,
            n_levels=len(levels), n_dofs=fine.dofh.n_dofs,
        ))
        paths[f"pmg_r7_mixed_{kind}"] = launches
        res_l.x = fine.to_global(res_l.x)
        extra = counter.calls if counter is not None else 0
        check_solve(f"PMG r=7 mixed {kind}", res_l, entries, launches, setup=False,
                    extra_launches=extra)
        rel = norm_rel(res_l.x, res_k.x)
        print(f"PMG quadrant r=7 p=4 mixed/float coarse {kind} (cycles {prm_l.mg_data.coarse_solver.n_cycles}) "
              f"on the same hierarchy: iterations {res_l.solve_iterations} (amg: {res_k.n_iterations}), "
              f"coarse-CG operator applications in the run {extra}, x vs amg {rel:.3e} relative, "
              f"solve {res_l.time:.6f} s (reps {[round(t, 6) for t in res_l.time_per_rep]}), "
              f"coarse build {t_build:.1f} s; card {card}", flush=True)
        check(rel <= 1e-3, f"coarse {kind} disagrees with coarse amg on the PMG r=7 hierarchy")
        del coarse, counter, mg_l, res_l
    del res_k, amg_k, fine, outer_op, _problem, levels, entries
    torch.cuda.empty_cache()

    # 4m. truncated HPMG quadrant r=6 p=4 (MinLevel 7: the fine mesh only),
    # double over float levels, beside the records' iteration counts
    for coarse, n_cycles, record in (
        ("amg", 1, 5), ("amg", 2, 4), ("amg", 3, 4), ("amg", 4, 4), ("amg_petsc", 2, 8),
    ):
        prm = bench_params(6, 4, "double", 2, "HPMG", "float", coarse, n_cycles, 7)
        torch.cuda.reset_peak_memory_stats()
        (res, _problem, levels), launches = counted(lambda: api.run(prm, dev))
        key = f"hpmg_r6_trunc_{coarse}_{n_cycles}"
        paths[key] = launches
        check(len(levels) == 3 and levels[0].dofh.n_dofs == 38_402 and res.n_dofs == 2_305_421,
              f"truncated HPMG r=6 plan: {[(lv.degree, lv.dofh.n_dofs) for lv in levels]}")
        entries = gc_entries(levels, prm)
        check_solve(f"HPMG r=6 MinLevel 7 {coarse} x{n_cycles}", res, entries, launches)
        amg = amg_of(res.mg.coarse_solve)
        print(f"HPMG quadrant r=6 p=4 MinLevel 7 double/float coarse {coarse} cycles {n_cycles}: "
              f"iterations {res.n_iterations} (record {record}, "
              f"{'equal' if res.n_iterations == record else 'DIFFERENT'}), AMG levels "
              f"{[d['rows'] for d in amg.describe()]}, solve {res.time:.6f} s, setup {res.setup_time:.1f} s, "
              f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}", flush=True)
        del res, _problem, levels, entries, amg
        torch.cuda.empty_cache()

    # 4n. AMG and AMGPETSc alone on quadrant r=7 p=1, double (gather engine:
    # no stencil launch)
    for mg_type in ("AMG", "AMGPETSc"):
        prm = bench_params(7, 1, "double", 3, mg_type, "double")
        torch.cuda.reset_peak_memory_stats()
        (res, _problem, levels), launches = counted(lambda: api.run(prm, dev))
        its = res.solve_iterations
        amg = amg_of(res.amg)
        print_amg(f"{mg_type} r=7 p=1", amg, card)
        print(f"{mg_type} quadrant r=7 p=1 double: n_dofs {res.n_dofs}, solve iterations {its}, "
              f"loop residual {res.residual_norm:.4e}, true residual {res.true_residual:.4e} "
              f"(allowance {res.guard_threshold:.4e}), solve {res.time:.6f} s "
              f"(reps {[round(t, 6) for t in res.time_per_rep]}), {res.throughput / 1e6:.3f} MDoF/s, "
              f"setup {res.setup_time:.1f} s, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"stencil launches {launches}; card {card}", flush=True)
        check(res.converged and len(set(its)) == 1 and res.n_dofs == 283_109 and res.n_levels == 1,
              f"{mg_type} r=7 p=1: converged {res.converged}, iterations {its}")
        check(res.true_residual <= res.guard_threshold, f"{mg_type} r=7 p=1: true-residual guard failed")
        check(launches == 0, f"{mg_type} runs on the gather engine but launched the stencil")
        check(len(amg.levels) >= 2 and bool(torch.isfinite(res.x).all()) and res.x.is_cuda,
              f"{mg_type} r=7 p=1: not an AMG solve on the card")
        del res, _problem, levels, amg
        torch.cuda.empty_cache()

    # 4o. the CLI: two parameter files, one cumulative table
    common = {"GeometryType": "quadrant", "NRefGlobal": 7, "Degree": 4, "SmootherDegree": 3,
              "RelativeTolerance": 1e-4, "MGNumberType": "float", "CoarseGridSolverType": "amg",
              "NRepetitions": 5, "ProfilePhases": True}
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for i, extra in enumerate((
            {"Type": "HMG-global", "NumberType": "float"},
            {"Type": "PMG", "NumberType": "mixed"},
        )):
            files.append(os.path.join(tmp, f"input_{i:04d}.json"))
            with open(files[-1], "w") as f:
                json.dump({**common, **extra}, f)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc, launches = counted(lambda: cli.main(files))
    print(text.getvalue(), flush=True)
    paths["cli_hmg_global_and_pmg_r7"] = launches
    check(rc == 0, f"the CLI returned {rc}")
    rows = parse_last_table(text.getvalue())
    check(len(rows) == 2 and list(rows[0]) == CLI_COLUMNS,
          f"CLI table: {len(rows)} rows, columns {list(rows[0]) if rows else None}")
    for row, mg_type, n_levels in zip(rows, ("HMG-global", "PMG"), (8, 3)):
        check(all(row[c] != "" for c in CLI_COLUMNS), f"CLI row {mg_type}: an empty cell in {row}")
        check(row["type"] == mg_type and row["n_dofs"] == "17551967" and row["converged"] == "True"
              and int(row["n_levels"]) == n_levels, f"CLI row {mg_type}: {row}")
        phase_sum = sum(float(row[f"time_{ph}"]) for ph in
                        ("pre", "residuum", "res", "cs", "pro", "edge_pro", "post", "to_mg", "to_global"))
        n_it, t_solve = int(row["n_iterations"]), float(row["time"])
        ratio = phase_sum * n_it / t_solve
        print(f"CLI {mg_type} r=7 p=4: iterations {n_it}, solve {t_solve} s, MG phases of one V-cycle "
              f"{ {ph: row['time_' + ph] for ph in ('pre', 'residuum', 'res', 'cs', 'pro', 'edge_pro', 'post', 'to_mg', 'to_global')} } "
              f"s, sum x iterations {phase_sum * n_it:.6f} s = {ratio:.3f} of the solve "
              f"({'below' if ratio < 1.0 else 'NOT below'} it); card {card}", flush=True)
        check(0.0 < ratio < PHASE_SUM_LIMIT,
              f"CLI {mg_type}: phase sum x iterations {phase_sum * n_it} s is not inside "
              f"(0, {PHASE_SUM_LIMIT}) x the solve's {t_solve} s")
    check(int(rows[0]["n_iterations"]) == 3, f"CLI HMG-global r=7: iterations {rows[0]['n_iterations']}")
    check(launches > 0, "the CLI runs launched no stencil")
    torch.cuda.empty_cache()

    # result lines
    print(json.dumps({"kernels": [{
        "name": "patch_stencil",
        "route": "cuda",
        "source": "dealii_multigrid_tpu_torch/csrc/patch_stencil.cu",
        "replaces": "dealii_multigrid_tpu/ops/pallas_stencil.py:71",
        "launches": paths["hmg_global_r7_float"],
        "launches_per_path": paths,
        "max_abs_err": measured["max_abs_err"],
        "ms": measured["ms"],
        "plain_ms": measured["plain_ms"],
        "bound_ms": measured["bound_ms"],
        "bound_by": measured["bound_by"],
        "roofline_share": measured["bound_ms"] / measured["ms"],
        "library_ms": None,  # no single PyTorch call computes this function
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
