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
     (512, 33) in both, and compute each shape's bound (phase x adds the
     bfloat16 instance);
  3c. build the Chebyshev step kernel (ops/chebyshev_step.py) and hold it
     to its plain version, the smoother's eager chain, bit for bit at the
     finest level of hypercube r=6 p=4 (512 x 33^3 slots), in float32 and
     float64: the recurrence step, the same with x and d one tensor, and
     the first step of a smoothing from x.  Time each (CUDA events) beside
     its bound by bytes (8 accesses of the level vector, 7 where x is d or
     no d is read) and the eager chain's time;
  3d. build the assembly exchange kernel (ops/assembly_exchange.py) and
     hold it to its plain version, the eager chain, bit for bit and run to
     run, in float32 and float64 at hypercube r=6 p=4's finest level, and
     (after b) in float32 at quadrant r=7's L5 and L7 and in float64 at L7;
     time each (CUDA events) beside its bound by bytes and the eager chain's
     time (with the copy the exchange made before the kernel);
  4. solve, each path through api.run on cuda:0 with the launch counts set
     to 0 just before it and read just after: the stencil's, the
     Chebyshev step kernel's, which every path checks at 5 (2 x degree - 1)
     per float32 or float64 smoothed level per V-cycle (bfloat16 levels run
     the eager chain) besides the warm-ups of its captures, and the exchange
     kernel's, which every path checks at its plan's launches (at most 3)
     per exchange on a float32 or float64 operator: one per operator
     application, one per restriction on its coarse level, the guard's and
     the right-hand side's, besides the warm-ups;
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
     k. PMG quadrant r=6 p=4 (2,305,421 DoFs; p = 4, 2, 1 on the fine
        mesh, smoothed-aggregation AMG on 38,402 DoFs), NumberType mixed,
        float levels, coarse type amg, 5 repetitions: converged, the guard,
        one iteration count in all six solves, launches as expected; prints
        the AMG hierarchy and the set-up split (the same configuration at
        r=7 runs through the CLI in o);
     l. on k's hierarchy: coarse types cg_with_amg, and amg_petsc with 2
        cycles: converged, one iteration count in all solves;
     m. HPMG quadrant r=6 p=4, MinLevel 7, double over float levels: amg
        with 1-4 cycles and amg_petsc with 2, beside the records' iteration
        counts (results/parameters-hp-amg-trunc-tpu-part2.txt, -part3.txt);
        fails on a row that did not converge;
     n. AMG and AMGPETSc on quadrant r=6 p=1 (38,402 DoFs), double (the
        AMG of r=7's p=1 mesh, 283,109 DoFs, is PMG's coarse solve in o);
     o. the CLI on two JSON files written to a temporary directory
        (HMG-global r=7 p=4 float, and k's configuration, both with
        ProfilePhases): two table rows with every column and time_cg > 0
        (time_cg = the instrumented iteration - its phase sum, unclamped:
        so the phase sum is below the iteration);
     p. run-to-run repeatability: one float32 input 20 times through
        HybridOperator.vmult, HybridTransfer.restrict and the Poisson
        right-hand side's assembly (Gaussian) at L7/L6 of b (h) and
        HybridTransfer.restrict of d's finest p-levels (p), LaplaceOperator.vmult and
        TwoLevelTransfer.restrict (h and p) of r's 2D HPMG hierarchy, and
        LSTransfer.restrict of r's 2D HMG-local: all 20 outputs bit-equal;
        each fixed-order table's width and bytes;
     q. 2D card against CPU, small (quadrant r=5 p=2): the five multigrid
        types in double (x to 1e-8), HMG-global and HMG-local mixed over
        float (x to 1e-5), equal iteration counts; df32 in 2D raises;
     r. 2D quadrant r=9 p=4 (1,064,825 DoFs): HMG-global float, HPMG
        mixed, HMG-local double over float levels, and PMG mixed (AMG on
        the fine mesh at p=1); 5 repetitions each: converged, the guard,
        one iteration count in all six solves; set-up, peak memory,
        MDoF/s; the draws' seconds and card-CPU equality as in u;
     s. Stokes on the hypercube: r=2 card against CPU (block-diagonal
        MINRES, triangular FGMRES(30)); r=3 FGMRES(30) to 1e-8 in 34
        iterations (results/stokes-nsinker-tpu.txt:8) with the true
        relative residual <= 1e-8; r=5 (859,812 DoFs) the same, best of 3;
     t. the CLI on a 2D JSON config (HMG-global r=8 p=4, ProfilePhases):
        one row with every column, time_cg > 0;
     u. the n-sinker Stokes model on the hypercube, float64, Chebyshev degree
        3, coarse amg, triangular FGMRES(30) to 1e-8: r=2 card against CPU
        (mean/mass at contrast 1e2, galerkin/wbfbt at 1e4; equal counts, x to
        1e-8 and 1e-6) and every tensor reachable from the operator and the
        preconditioner on the card; galerkin/wbfbt at r=3 with the record's
        right-hand side (the second draw of default_rng(0)): 28 iterations at
        contrast 1e4 and 39-43 at 1e6 (results/stokes-nsinker-tpu.txt:10-11;
        43 on the TPU, 39-41 in the JAX package on the CPU under 1e-15
        changes of b), true relative residual <= 1e-8, and at 1e6 the counts
        of 8 such changes, each converged to 1e-8; r=5 (859,812 DoFs) at
        1e6, a warm-up and one timed solve, one count in both and that count
        108, the JAX package's on the CPU, with the host set-up split; in
        every row the seconds of the eigenvalue start-vector draws inside
        the set-up (``utils.threefry.normal``), beside those of NumPy's
        ``default_rng(42)`` for the same entries, and the largest draw made
        on the card bit-equal to the same draw made on the CPU;
     v. the convection demo: r=2, 3 steps card against CPU (equal counts, T
        to 1e-10); r=4 (112,724 DoFs) 5 steps at constant viscosity and 3
        under eta = 10 exp(-3 T): every step converged, T in [0, 1] to
        1e-10, wT rising; per-step seconds of the solve and the rebuild;
        u and v run on the gather engine and ELL products: no stencil launch;
     w. debug mode (MGTPU_DEBUG=1): HMG-global r=3 p=4 and HMG-local r=3 p=2
        in double take the counts and x of the plain solves, with the
        expected stencil launches; one NaN in a smoother's diagonal raises
        FloatingPointError naming the phase 'pre' (the only error caught);
        the variable is restored afterwards;
     x. bfloat16 levels (MGNumberType bfloat16): the bfloat16 instance of
        the kernel at phase 3's shapes, held elementwise to one rounding
        (2^-8 relative + 1e-5 of the maximum) of a float64 stencil of its
        own bfloat16 inputs and to 2e-2 of the maximum of the plain
        bfloat16 version; at the six main-path shapes, and at (512, 33) and
        (27, 9) on a view that starts one element into its buffer (rows at
        the other 4-byte alignment), bit for bit the float32 instance on
        the same values widened to float32 and rounded once; timed at the
        six main-path shapes; card
        against CPU at r=3 p=4 (HMG-global bfloat16 under float and under
        double, float under float, HPMG and HMG-local bfloat16 under
        double): the CPU's plain chain takes the JAX package's counts (4,
        4, 4, 4, 5) and the card the counts of the port's CPU run whose
        stencil rounds once, as the kernel does (``one_rounding_stencil``),
        and of the JAX package so rounded on the CPU (4, 4, 4, 4, 4);
        HMG-global r=7 p=4 bfloat16 under float and HPMG r=7 p=4 bfloat16
        under mixed, 5 repetitions each: converged, the guard, one count in
        all solves, float32 and bfloat16 launches as expected, peak memory,
        set-up, MDoF/s; phase p's sites (20 runs bit-equal) on their
        bfloat16 levels;
     y. the port's experiment runner (tools/run_experiment.py) on the card,
        one timed solve after the warm-up per row, over small-scaling
        quadrant up to r=4 (8 rows) against
        results/small-scaling-quadrant-tpu-merged.txt: every row equal,
        none failed, the card named in the artifact's header and rows; and
        over large_scaling_partitioning 8,1 at its first refinement, r=4,
        degree 4 (6 rows: three types or policies, NShards 8 and 1) against
        results/large-scaling-partitioning-virtual8.txt: every row the
        record's count, each 8-rank row the record's partition columns
        (the whole sweeps run in tools/recorded_sweeps.sh);
     z. sharded solves through the port's launcher (parallel/launch.py),
        every rank on cuda:0 over gloo (ranks sharing one card: correctness,
        not a multi-GPU speed): z1, HMG-global r=7 p=4 float over 4 ranks,
        3 repetitions: 3 iterations on every rank, the guard, x within 1e-5
        of b's, each rank's stencil launches equal to its own levels'
        count, the kernel against the plain version at every rank-local
        (NP, S), per rank peak memory, set-up and the L7 ghost slots
        imported per vmult below 10% of its owned slots; z3, two more
        float32 solves on z1's hierarchy, x bit-equal; z2, the JAX
        package's dryrun configuration (quadrant p=3, double, rtol 1e-10;
        r=4 where the JAX package runs r=5) over 8 ranks: HMG-global with
        the Morton default and with CellWeightPolicy-2.0, HMG-local with
        per-level partitions, each within 1e-12 of the one-rank card solve
        with equal counts;
  5. for every patch level of the b, d, f, h, i, k and x hierarchies (h and
     i through ``result.mg`` and ``result.ls_mg``): the kernel on the level's
     own KS, MS and pscale against the plain version, its time, launches
     per solve and bound; then the seconds each phase took, the kernels
     line (one entry per instance: float32, float64, bfloat16; the
     bfloat16 entry also carries its time and roofline share at each
     main-path shape), the card's name and power limit, and the result
     line.

The expected launch counts come from the same per-level entries
(``gc_entries``, ``ls_entries``) that step 5 reads.  ``ops.kernels``
counts the launches that reached the card, each CUDA graph replay's
included (solvers/vcycle_graph.py); a path's expected count adds each
capture's eager warm-up.  The result line carries the graphs' counts.
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

from dealii_multigrid_tpu_torch.ops import kernels

F32_RTOL, F32_ATOL_REL = 2e-5, 2e-4   # f32: atol = 2e-4 * max|ref|
F64_REL = 1e-12                        # f64: max|err| / max|ref|
TIMED_LAUNCHES = 50
#: (NP, S) of the patch levels L7..L2 of quadrant r=7 p=4, finest first
MAIN_SHAPES = ((512, 33), (64, 33), (8, 33), (8, 17), (27, 9), (8, 9))
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP32 and FP64 (non-tensor)
# peaks, and the bf16 (dense tensor-core) peak: the least time for the same
# work on bfloat16 inputs (the bfloat16 instance itself computes in FP32 FMA)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}
#: the bfloat16 instance against a float64 stencil of its own bfloat16
#: inputs: one rounding to nearest (2^-8 relative) plus float32
#: accumulation (1e-5 of max|ref64|), elementwise
BF16_RTOL, BF16_ATOL_REL = 2.0**-8, 1e-5
#: ... and against the plain bfloat16 tensordot chain: max|err| / max|plain|
BF16_PLAIN_REL = 2e-2
DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


T_START = time.perf_counter()
#: (phase, elapsed seconds where it starts), in order
STAMPS: list = []


def stamp(phase: str) -> None:
    """The script's elapsed time where a phase starts (where the time goes)."""
    STAMPS.append((phase, time.perf_counter() - T_START))
    print(f"[chip_smoke] phase {phase} starts at {STAMPS[-1][1]:.1f} s", flush=True)


def phase_seconds() -> dict:
    """Seconds from each stamp to the next (the last one to now)."""
    ends = [t for _, t in STAMPS[1:]] + [time.perf_counter() - T_START]
    return {name: round(end - t, 1) for (name, t), end in zip(STAMPS, ends)}


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
    measured = {"max_abs_err": 0.0, "max_abs_err_f64": 0.0, "shapes": {}}

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
        if what == "main-path":
            key = "max_abs_err" if dtype == torch.float32 else "max_abs_err_f64"
            measured[key] = max(measured[key], err)

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
    measured["per_dtype"] = {}
    for dtype, shapes in ((torch.float32, MAIN_SHAPES), (torch.float64, MAIN_SHAPES[:1])):
        for NP, S in shapes:
            KS, MS = assembled(4, S, dtype, dev)
            xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
            sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
            b_ms, b_by = bound(NP, S, KS, MS, dtype)
            ms = time_shape(measured, dtype, NP, S, xp, KS, MS, sc)
            print(f"stencil timing {DTYPE_TAG[dtype]} NP={NP} S={S}: {ms:.6f} ms, bound "
                  f"{1e3 * b_ms:.2f} us ({b_by}), roofline share {b_ms / ms:.4f}", flush=True)
            measured["shapes"][(dtype, NP, S)] = (ms, b_ms, b_by)
    ms, b_ms, b_by = measured["shapes"][(torch.float32, 512, 33)]
    measured.update(ms=ms, bound_ms=b_ms, bound_by=b_by,
                    plain_ms=measured["per_dtype"][torch.float32]["plain_ms"])
    for dtype in (torch.float32, torch.float64):
        ms, b_ms, b_by = measured["shapes"][(dtype, 512, 33)]
        measured["per_dtype"][dtype].update(ms=ms, bound_ms=b_ms, bound_by=b_by)
    measured["per_dtype"][torch.float32]["max_abs_err"] = measured["max_abs_err"]
    measured["per_dtype"][torch.float64]["max_abs_err"] = measured["max_abs_err_f64"]
    return measured


def time_shape(measured: dict, dtype, NP: int, S: int, xp, KS, MS, sc) -> float:
    """The kernel's time (CUDA events, the better of two runs of
    TIMED_LAUNCHES launches) at one shape; at (512, 33) also the plain
    version's, in turns (plain, kernel, kernel, plain), into
    ``measured["per_dtype"][dtype]["plain_ms"]``."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    kern = lambda: ps.patch_stencil(xp, KS, MS, sc, 4)  # noqa: E731
    if (NP, S) != (512, 33):
        return min(time_ms(kern, TIMED_LAUNCHES), time_ms(kern, TIMED_LAUNCHES))
    plain = lambda: ps.patch_stencil_reference(xp, KS, MS, sc)  # noqa: E731
    t_plain = [time_ms(plain, TIMED_LAUNCHES)]
    t_kern = [time_ms(kern, TIMED_LAUNCHES), time_ms(kern, TIMED_LAUNCHES)]
    t_plain.append(time_ms(plain, TIMED_LAUNCHES))
    measured["per_dtype"].setdefault(dtype, {})["plain_ms"] = min(t_plain)
    print(f"stencil NP=512 S=33 {DTYPE_TAG[dtype]}: kernel {t_kern} ms, plain {t_plain} ms "
          f"(each the mean of {TIMED_LAUNCHES} launches)", flush=True)
    return min(t_kern)


#: slots of the finest level of hypercube r=6 p=4 (512 patches of 33^3)
FINEST_SLOTS = 512 * 33**3


def check_chebyshev_step(dev: torch.device, card: str) -> dict:
    """Phase 3c: the Chebyshev step kernel against its plain version, bit
    for bit, and its times; {dtype: {step: (ms, plain_ms, bound_ms,
    max_abs_err)}}, the error the largest |kernel - plain| over x' and d'."""
    from dealii_multigrid_tpu_torch.ops import chebyshev_step as cs
    from dealii_multigrid_tpu_torch.solvers.chebyshev import ChebyshevSmoother

    secs = cs.library.build()
    print(f"Chebyshev step kernel build: {secs:.1f} s -> {cs.library.path}", flush=True)
    if cs.library.build_log.strip():
        print(cs.library.build_log.strip(), flush=True)
    n = FINEST_SLOTS
    out: dict = {}
    for dtype in (torch.float32, torch.float64):
        gen = torch.Generator(device=dev).manual_seed(18)
        ar, x, d, b = (torch.randn(n, generator=gen, dtype=dtype, device=dev) for _ in range(4))
        keep = (torch.rand(n, generator=gen, device=dev) < 0.8).to(dtype)
        inv = torch.rand(n, generator=gen, dtype=dtype, device=dev) + 0.5
        sm = ChebyshevSmoother.create(None, None, max_eigenvalue=2.6, degree=3)
        theta, delta, sigma = sm._scalars(dtype)
        rho_old = 1.0 / sigma
        rho = 1.0 / (2.0 * sigma - rho_old)
        c_d, c_r, theta = rho * rho_old, 2.0 * rho / delta, float(theta)
        steps = {
            "recurrence": (
                lambda: cs.recurrence_step(ar, keep, x, d, b, inv, c_d, c_r),
                lambda: cs.recurrence_reference(cs.blend(ar, keep, x), x, d, b, inv, c_d, c_r), 8),
            "recurrence x=d": (
                lambda: cs.recurrence_step(ar, keep, x, x, b, inv, c_d, c_r),
                lambda: cs.recurrence_reference(cs.blend(ar, keep, x), x, x, b, inv, c_d, c_r), 7),
            "first": (
                lambda: cs.first_step(ar, keep, x, b, inv, theta),
                lambda: cs.first_reference(cs.blend(ar, keep, x), x, b, inv, theta), 7),
        }
        size = torch.empty((), dtype=dtype).element_size()
        out[dtype] = {}
        for name, (kern, plain, accesses) in steps.items():
            got, want = kern(), plain()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            check(same, f"Chebyshev step kernel ({name}, {DTYPE_TAG[dtype]}) differs from its "
                  f"plain version: max_abs_err={err:.3e}")
            del got, want
            bound_ms = 1e3 * accesses * n * size / HBM_BYTES_PER_S
            t_plain = [time_ms(plain, TIMED_LAUNCHES)]
            t_kern = [time_ms(kern, TIMED_LAUNCHES), time_ms(kern, TIMED_LAUNCHES)]
            t_plain.append(time_ms(plain, TIMED_LAUNCHES))
            ms = min(t_kern)
            print(f"Chebyshev step {name} {DTYPE_TAG[dtype]} N={n}: bit-equal to the eager chain "
                  f"(max_abs_err={err:.3e}); "
                  f"kernel {ms:.6f} ms {t_kern}, eager chain {min(t_plain):.6f} ms {t_plain}, "
                  f"bound {1e3 * bound_ms:.2f} us ({accesses} accesses), roofline share "
                  f"{bound_ms / ms:.4f}; card {card}", flush=True)
            out[dtype][name] = (ms, min(t_plain), bound_ms, err)
    return out


def check_exchange(label: str, op, card: str) -> tuple:
    """Phase 3d: the exchange kernel on one level (``op``, a HybridOperator on
    the card) against the eager chain, bit for bit, run to run, and with its
    plan's launches; its time (CUDA events, on a zero vector: the time does
    not depend on the values) beside its bound by bytes (``ExchangePlan.
    bytes``) and the eager chain's time, with the whole-vector copy the
    exchange made before the kernel; (ms, plain_ms, bound_ms, max_abs_err)."""
    from dealii_multigrid_tpu_torch.ops import assembly_exchange as ax

    plan = op.exchange_plan
    gen = torch.Generator(device=op.device).manual_seed(20)
    raw = torch.randn(op.n_slots, generator=gen, dtype=op.dtype, device=op.device)
    want = ax.reference_(op, raw.clone())
    before = ax.launches.count
    got, again = op.exchange_(raw.clone()), op.exchange_(raw.clone())
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tag = f"exchange kernel at {label} ({DTYPE_TAG[op.dtype]}, NP={op.NP} S={op.S} NS={op.NS} " \
          f"use_cross={op.use_cross}, {plan.n_groups} irregular groups)"
    check(ax.launches.count - before == 2 * plan.launches,
          f"{tag}: {ax.launches.count - before} launches for two exchanges of {plan.launches}")
    check(torch.equal(got, again), f"{tag}: two runs differ")
    check(torch.equal(got, want), f"{tag}: differs from the eager chain, max_abs_err={err:.3e}")
    del got, again, want, raw
    buf = torch.zeros(op.n_slots, dtype=op.dtype, device=op.device)
    bound_ms = 1e3 * plan.bytes(op.dtype) / HBM_BYTES_PER_S
    t_plain = [time_ms(lambda: ax.reference_(op, buf.clone()), TIMED_LAUNCHES)]
    t_kern = [time_ms(lambda: op.exchange_(buf), TIMED_LAUNCHES) for _ in range(2)]
    t_plain.append(time_ms(lambda: ax.reference_(op, buf.clone()), TIMED_LAUNCHES))
    ms = min(t_kern)
    print(f"{tag}: bit-equal to the eager chain, bit-repeatable, {plan.launches} launches; kernel "
          f"{ms:.6f} ms {t_kern}, eager chain {min(t_plain):.6f} ms {t_plain}, bound "
          f"{1e3 * bound_ms:.2f} us ({plan.bytes(op.dtype)} bytes), roofline share "
          f"{bound_ms / ms:.4f}; card {card}", flush=True)
    return ms, min(t_plain), bound_ms, err


class Entry(NamedTuple):
    """One operator of a solve path, as the stencil launches it, and the
    Chebyshev step kernel launches of its smoother."""

    label: str
    op: object                  # HybridOperator
    per_iteration: int          # launches per CG iteration
    dtype: torch.dtype          # dtype of those launches
    setup: int                  # launches of the eigenvalue estimate
    steps: int = 0              # step kernel launches per CG iteration


def smoother_steps(dtype: torch.dtype, prm) -> int:
    """Step kernel launches of one V-cycle visit of a smoothed level:
    degree - 1 in the pre-smoother (its first step from zero applies no
    operator), degree in the post-smoother; none on a bfloat16 level."""
    if dtype not in (torch.float32, torch.float64):
        return 0
    return 2 * prm.mg_data.smoother.degree - 1


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
              2 * deg + (1 if l == len(levels) - 1 else 0), levels[l].op.dtype, eig,
              smoother_steps(levels[l].op.dtype, prm))
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
    out += [Entry(f"p={p_ops[l].n1 - 1}", p_ops[l], 2 * deg, p_ops[l].dtype, eig,
                  smoother_steps(p_ops[l].dtype, prm))
            for l in range(len(p_ops) - 1, 0, -1)]
    out += [Entry(f"LS L{l}", ls_levels[l].op, 2 * deg + 2, ls_levels[l].op.dtype, eig,
                  smoother_steps(ls_levels[l].op.dtype, prm))
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


def exchange_launches_of(op) -> int:
    """Exchange kernel launches of one exchange on ``op``: its plan's axes
    with a group where the kernel takes the level's vectors (CUDA, float32
    or float64); none on bfloat16 levels, which run the torch chain."""
    from dealii_multigrid_tpu_torch.ops import assembly_exchange as ax

    plan = getattr(op, "exchange_plan", None)
    return plan.launches if plan is not None and op.dtype in ax.DTYPES else 0


def restriction_ops(*cycles) -> list:
    """The coarse operator of each restriction in one application of the
    V-cycles ``cycles`` (Multigrid and local-smoothing hierarchies; None
    skipped): each restriction ends with one exchange on it."""
    return [t.coarse_op for mg in cycles if mg is not None
            for t in mg.transfers if hasattr(t, "coarse_op")]


def expected_exchanges(entries, restrictions, iterations, setup: bool = True,
                       extra: int = 0, extra_op=None) -> int:
    """Exchange kernel launches a solve path implies: each operator
    application one exchange (the entries' applications per iteration and,
    with ``setup``, their eigenvalue estimates and the right-hand side's
    assembly on the finest entry), each restriction one on its coarse
    operator per iteration, the residual guard one on the finest entry, and
    ``extra`` applications of ``extra_op`` (a coarse CG); times each
    operator's launches per exchange."""
    n_it = sum(iterations)
    n = sum(exchange_launches_of(e.op) * (e.per_iteration * n_it + (e.setup if setup else 0))
            for e in entries)
    n += n_it * sum(exchange_launches_of(op) for op in restrictions)
    n += exchange_launches_of(entries[0].op) * (2 if setup else 1)
    return n + (extra * exchange_launches_of(extra_op) if extra else 0)


#: Chebyshev step kernel launches per path, as ``paths`` holds the stencil's
STEP_PATHS: dict = {}
#: exchange kernel launches per path
EXCHANGE_PATHS: dict = {}


def counted(fn):
    """Run fn with every kernel's launch count set to 0 just before;
    (result, stencil launches)."""
    torch.cuda.synchronize()
    kernels.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, sum(launched_per_dtype().values())


def launched_per_dtype(kernel: str = "patch_stencil") -> dict:
    """Launches of ``kernel`` per dtype since ``counted`` set the counts to 0."""
    return kernels.counts().get(kernel, {})


def warmup_launches(kernel: str = "patch_stencil") -> dict:
    """Launches of ``kernel`` per dtype of the eager warm-ups since
    ``counted`` set the counts to 0, as many as the captures recorded."""
    return kernels.counts(kernels.RECORDED).get(kernel, {})


def publish(paths: dict, key: str, launches: int) -> None:
    """A path's stencil launches into ``paths``, and its step and exchange
    kernel launches, as ``counted`` last counted them, into STEP_PATHS and
    EXCHANGE_PATHS."""
    paths[key] = launches
    STEP_PATHS[key] = sum(launched_per_dtype("chebyshev_step").values())
    EXCHANGE_PATHS[key] = sum(launched_per_dtype("assembly_exchange").values())


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def check_solve(name: str, result, entries, launches: int, n_it: int | None = None,
                setup: bool = True, extra_launches: int = 0, cycles: tuple | None = None,
                extra_exchanges: int = 0) -> None:
    """The checks every full-size path makes, and its line of numbers.
    ``extra_launches``: launches the entries do not describe (a coarse CG on
    the coarsest level's operator), counted by the caller; the warm-ups of
    the captures (``warmup_launches``) are added here.  The Chebyshev step
    kernel launches each entry's ``steps`` per V-cycle, one V-cycle per CG
    iteration, besides its warm-ups.  The exchange kernel launches as
    ``expected_exchanges`` counts, with the restrictions of ``cycles``
    (the result's own hierarchies where None) and ``extra_exchanges`` the
    caller counted, besides its warm-ups."""
    expect = (expected_launches(entries, result.solve_iterations, setup) + extra_launches
              + sum(warmup_launches().values()))
    its = result.solve_iterations
    steps = sum(launched_per_dtype("chebyshev_step").values())
    expect_steps = (sum(its) * sum(e.steps for e in entries)
                    + sum(warmup_launches("chebyshev_step").values()))
    cycles = (result.mg, result.ls_mg) if cycles is None else cycles
    exchanges = sum(launched_per_dtype("assembly_exchange").values())
    expect_exchanges = (expected_exchanges(entries, restriction_ops(*cycles), its, setup)
                        + extra_exchanges + sum(warmup_launches("assembly_exchange").values()))
    print(f"{name}: operators (label, NP, S, band, launches per iteration) "
          f"{[(e.label, e.op.NP, e.op.S, e.op.band, e.per_iteration) for e in entries]}",
          flush=True)
    print(f"{name}: solve iterations {its}; loop residual {result.residual_norm:.4e}, "
          f"true residual {result.true_residual:.4e} (allowance {result.guard_threshold:.4e}); "
          f"stencil launches {launches} (expected {expect}); Chebyshev step kernel launches "
          f"{steps} (expected {expect_steps}); exchange kernel launches {exchanges} "
          f"(expected {expect_exchanges})", flush=True)
    check(result.converged, f"{name} did not converge")
    check(len(set(its)) == 1, f"{name}: the solves took different iteration counts {its}")
    if n_it is not None:
        check(its[0] == n_it, f"{name}: expected {n_it} CG iterations, got {its}")
    check(result.true_residual <= result.guard_threshold, f"{name}: true-residual guard failed")
    check(launches > 0 and launches == expect, f"{name}: stencil launches {launches} != expected {expect}")
    check(steps == expect_steps, f"{name}: step kernel launches {steps} != expected {expect_steps}")
    check(exchanges == expect_exchanges,
          f"{name}: exchange kernel launches {exchanges} != expected {expect_exchanges}")
    check("jax" not in sys.modules, "the port imported jax")
    x = result.x
    check(x.shape == (result.n_dofs,) and bool(torch.isfinite(x).all()),
          f"{name}: the solution is not a finite vector of n_dofs values")


def check_levels(name: str, entries, iterations: int, card: str, rng) -> None:
    """Each patch level's own KS, MS and pscale through the kernel against the
    plain version (the level's dtype and float64; bfloat16 as
    ``compare_bf16``), its time with CUDA events
    in the dtype the solve launches it in, and launches per solve (of
    ``iterations`` CG iterations) x time against the bound."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    total = 0.0
    for label, op, per_iteration, run_dtype, *_ in entries:
        if op.NP == 0:
            continue
        n = per_iteration * iterations
        for dtype in (op.dtype, torch.float64):
            KS, MS, sc = (t.to(dtype).contiguous() for t in (op.KS, op.MS, op.pscale))
            xp = torch.as_tensor(rng.standard_normal((op.NP, op.S**3)), dtype=dtype, device=op.device)
            if dtype == torch.bfloat16:
                compare_bf16(f"{name} {label}", xp, KS, MS, sc, op.band)
                continue
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
        tag = DTYPE_TAG[run_dtype]
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
    """The AMG a coarse solver runs (itself, a coarse CG's, a slot wrapper's), or fails."""
    from dealii_multigrid_tpu_torch.solvers.amg import AMGPreconditioner
    from dealii_multigrid_tpu_torch.solvers.coarse import CGCoarseSolver, SlottedSolver

    amg = solver.preconditioner if isinstance(solver, CGCoarseSolver) else solver
    amg = amg.inner if isinstance(amg, SlottedSolver) else amg
    check(isinstance(amg, AMGPreconditioner), f"no AMG inside {type(solver).__name__}")
    return amg


def print_amg(name: str, amg, card: str) -> None:
    rows = amg.describe()
    print(f"{name}: AMG hierarchy, finest first (rows, widest row of A / P / P^T, MiB of "
          f"device tables, omega) "
          f"{[(d['rows'], d['K_A'], d['K_P'], d['K_PT'], round(d['bytes'] / 2**20, 2), round(d['omega'], 4)) for d in rows]}; "
          f"dense coarsest factor {tuple(amg.chol.shape)} {amg.chol.dtype}, "
          f"{amg.chol.numel() * amg.chol.element_size() / 2**20:.1f} MiB; tables "
          f"{sum(d['bytes'] for d in rows) / 2**20:.1f} MiB; cycles {amg.n_cycles}; the process's AMG "
          f"set-up spans so far (s) {amg_setup()}; card {card}", flush=True)


def amg_setup() -> dict:
    """The AMG set-up spans' seconds so far in the process."""
    from dealii_multigrid_tpu_torch.utils.phases import SETUP

    return {n: round(SETUP.seconds(f"mgtpu.setup.amg_{n}"), 3) for n in ("build", "upload", "factor")}


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



# ---------------------------------------------------------------------------
# phases p-t (2D multigrid, the gather engine, Stokes, fixed-order sums)
# ---------------------------------------------------------------------------

#: phase p's sites; every one must have been checked by the end of the run
P_SITES = (
    "HybridOperator.vmult", "HybridTransfer.restrict h", "HybridTransfer.restrict p",
    "LaplaceOperator.vmult", "TwoLevelTransfer.restrict h", "TwoLevelTransfer.restrict p",
    "LSTransfer.restrict", "Poisson RHS",
)
#: phase p's sites on phase x's bfloat16 hierarchies
P_SITES_BF16 = ("HybridOperator.vmult bf16", "HybridTransfer.restrict h bf16",
                "HybridTransfer.restrict p bf16")
#: 2D quadrant r=9 p=4, as the port's host set-up counts them
N_DOFS_2D_R9 = 1_064_825


def table_desc(tables: dict) -> str:
    if not tables:
        return "none"
    return ", ".join(
        f"{name} width {t.width} {t.nbytes / 2**20:.2f} MiB" for name, t in tables.items()
        if t is not None
    )


def repeat_check(label: str, where: str, fn, x: torch.Tensor, tables: dict, done: set,
                 card: str, n: int = 20) -> None:
    """Phase p: the same float32 (bfloat16 on phase x's hierarchies) input
    through ``fn`` n times on the card; every output must equal the first bit
    for bit."""
    check(x.dtype in (torch.float32, torch.bfloat16) and x.is_cuda,
          f"phase p {label}: input not float32 or bfloat16 on the card")
    ref = fn(x)
    same = 1
    for _ in range(n - 1):
        same += int(torch.equal(fn(x), ref))
    torch.cuda.synchronize()
    print(f"phase p {label} ({where}): {same} of {n} runs bit-equal; output {tuple(ref.shape)}; "
          f"fixed-order tables: {table_desc(tables)}; card {card}", flush=True)
    check(same == n, f"phase p {label}: only {same} of {n} float32 runs are bit-equal")
    done.add(label)


def hybrid_sites(levels, mg, done: set, card: str, where: str, p_transfer: bool) -> None:
    """Phase p on a hybrid hierarchy: the finest operator's vmult and the
    finest h- (or p-) restriction, on consistent slot vectors of the levels'
    dtype (float32; bfloat16 in phase x, whose sites carry the suffix
    " bf16"); on a float32 h-hierarchy also the Poisson right-hand side."""
    fine, coarse = levels[-1], levels[-2]
    tr = mg.transfers[-1]
    rng = np.random.default_rng(20)
    dtype = fine.op.dtype
    tag = "" if dtype == torch.float32 else f" {DTYPE_TAG[dtype]}"
    x = torch.as_tensor(fine.fmt.from_global(rng.standard_normal(fine.dofh.n_dofs)),
                        dtype=dtype, device=fine.op.device)
    if not p_transfer:
        repeat_check("HybridOperator.vmult" + tag, where, fine.op.vmult, x, fine.op.sum_tables(),
                     done, card)
    tables = {"restrict": tr.restrict_sum, **{f"coarse {k}": v for k, v in coarse.op.sum_tables().items()}}
    kind = "p" if p_transfer else "h"
    repeat_check(f"HybridTransfer.restrict {kind}{tag}", where, tr.restrict, x, tables, done, card)
    if not p_transfer and not tag:
        from dealii_multigrid_tpu_torch.models import poisson
        from dealii_multigrid_tpu_torch.ops.hybrid_format import cell_slot_table

        # the host sums the cell integrals into the slots (np.bincount)
        slots = cell_slot_table(fine.fmt)
        repeat_check("Poisson RHS", where, lambda _: poisson.assemble_problem_hybrid(
            fine.dofh, fine.hanging, fine.op, slots, fine.fmt, "Gaussian")[1], x, {}, done, card)
        del slots
        t_v = time_ms(lambda: fine.op.vmult(x), 10)
        t_r = time_ms(lambda: tr.restrict(x), 10)
        print(f"fixed-order sums at {where}: HybridOperator.vmult {t_v:.4f} ms, HybridTransfer.restrict "
              f"{t_r:.4f} ms (each the mean of 10 calls queued behind a sleep); card {card}", flush=True)


def gather_sites(res_gc, levels_gc, res_ls, done: set, card: str, where: str) -> None:
    """Phase p on 2D gather hierarchies: the fine LaplaceOperator, the finest
    h- and p-transfers of an HPMG hierarchy, the finest LS transfer."""
    from dealii_multigrid_tpu_torch.ops.transfer import TwoLevelTransfer

    rng = np.random.default_rng(21)
    dev = torch.device("cuda:0")

    def vec(n):
        return torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)

    op = levels_gc[-1].op
    repeat_check("LaplaceOperator.vmult", where, op.vmult, vec(op.n_dofs),
                 {"cell": op.cell_sum, "masters": op.hanging.master_sum}, done, card)
    trs = res_gc.mg.transfers
    for kind, l in (("p", len(trs) - 1), ("h", next(l for l in range(len(trs) - 1, 0, -1)
                                                   if levels_gc[l].degree == levels_gc[l - 1].degree))):
        tr = trs[l]
        check(isinstance(tr, TwoLevelTransfer), "the 2D transfer is not a TwoLevelTransfer")
        repeat_check(f"TwoLevelTransfer.restrict {kind}", where, tr.restrict, vec(tr.n_dofs_fine),
                     {"restrict": tr.restrict_sum, "coarse masters": tr.coarse_hanging.master_sum},
                     done, card)
    lt = res_ls.ls_mg.transfers[-1]
    repeat_check("LSTransfer.restrict", where, lt.restrict, vec(lt.n_f),
                 {"restrict": lt.restrict_sum}, done, card)


def params_2d(n_ref: int, degree: int, number: str, reps: int, mg_type: str,
              mg_number: str | None = None):
    prm = bench_params(n_ref, degree, number, reps, mg_type, mg_number)
    prm.dim = 2
    return prm


def phase_q(dev, card: str) -> None:
    """2D card against CPU, small (quadrant r=5 p=2): the five multigrid
    types in double (x to 1e-8), HMG-global and HMG-local mixed over float
    levels (x to 1e-5), equal iteration counts; df32 in 2D raises."""
    from dealii_multigrid_tpu_torch import api

    runs = [(t, "double", "double", 1e-8) for t in
            ("HMG-global", "PMG", "HPMG", "HMG-local", "HPMG-local")]
    runs += [(t, "mixed", "float", 1e-5) for t in ("HMG-global", "HMG-local")]
    for mg_type, number, mg_number, tol in runs:
        prm = params_2d(5, 2, number, 1, mg_type, mg_number)
        res_gpu, _, _ = api.run(prm, dev)
        res_cpu, _, _ = api.run(prm, "cpu")
        rel = max_rel(res_gpu.x, res_cpu.x)
        print(f"phase q: 2D {mg_type} r=5 p=2 {number}/{mg_number}: n_dofs {res_gpu.n_dofs}, card "
              f"{res_gpu.n_iterations} it, cpu {res_cpu.n_iterations} it, max rel diff {rel:.3e} "
              f"(limit {tol:g})", flush=True)
        check(res_gpu.converged and res_gpu.n_iterations == res_cpu.n_iterations and rel <= tol
              and res_gpu.x.is_cuda and res_gpu.x.dtype == res_cpu.x.dtype,
              f"2D card solve disagrees with the CPU solve ({mg_type} {number})")
    try:
        api.run(params_2d(5, 2, "df32", 1, "HMG-global", "float"), dev)
    except ValueError as exc:
        print(f"phase q: 2D df32 raises ValueError: {exc}", flush=True)
    else:
        check(False, "2D df32 did not raise ValueError")


def run_2d(prm, dev, card: str, name: str, n_it: int | None = None):
    """One full-size 2D run on the card; the checks and line of phase r."""
    from dealii_multigrid_tpu_torch import api

    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with draw_clock() as draws:
        (res, problem, levels), launches = counted(lambda: api.run(prm, dev))
    wall = time.perf_counter() - t0
    its = res.solve_iterations
    print(f"phase r: {name}: n_dofs {res.n_dofs}, levels {res.n_levels}, solve iterations {its}, "
          f"loop residual {res.residual_norm:.4e}, true residual {res.true_residual:.4e} "
          f"(allowance {res.guard_threshold:.4e}), solve {res.time:.6f} s "
          f"(reps {[round(t, 6) for t in res.time_per_rep]}), {res.throughput / 1e6:.3f} MDoF/s, "
          f"setup {res.setup_time:.1f} s, run wall {wall:.1f} s, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (allocated before "
          f"{before:.2f} GiB), stencil launches {launches}; card {card}", flush=True)
    report_draws("r", name, draws, card)
    check(res.converged, f"{name} did not converge")
    check(len(set(its)) == 1 and len(its) == prm.mg_data.n_repetitions + 1,
          f"{name}: the solves took different iteration counts {its}")
    check(n_it is None or its[0] == n_it, f"{name}: expected {n_it} iterations, got {its}")
    check(res.true_residual <= res.guard_threshold, f"{name}: true-residual guard failed")
    check(launches == 0, f"{name}: the 2D gather engine launched the stencil")
    check(bool(torch.isfinite(res.x).all()) and res.x.is_cuda, f"{name}: x not finite on the card")
    return res, levels


def phase_r(dev, card: str, n_ref: int, done: set) -> dict:
    """2D quadrant p=4 at refinement n_ref: HMG-global float, HPMG mixed over
    float levels, HMG-local double over float levels, PMG mixed (its
    coarse level is the fine mesh at p=1, an AMG solve); phase p's
    gather-engine sites on the HPMG and HMG-local hierarchies."""
    out = {}
    res, levels = run_2d(params_2d(n_ref, 4, "float", 5, "HMG-global"), dev, card,
                         f"2D HMG-global r={n_ref} p=4 float")
    if n_ref == 9:
        check(res.n_dofs == N_DOFS_2D_R9, f"2D r=9: {res.n_dofs} DoFs")
    out["hmg_global"] = res.n_iterations
    del res, levels
    res_gc, levels_gc = run_2d(params_2d(n_ref, 4, "mixed", 5, "HPMG", "float"), dev, card,
                               f"2D HPMG r={n_ref} p=4 mixed/float")
    out["hpmg"] = res_gc.n_iterations
    res_ls, _ = run_2d(params_2d(n_ref, 4, "double", 5, "HMG-local", "float"), dev, card,
                       f"2D HMG-local r={n_ref} p=4 double/float")
    out["hmg_local"] = res_ls.n_iterations
    gather_sites(res_gc, levels_gc, res_ls, done, card, f"2D r={n_ref}")
    del res_gc, levels_gc, res_ls
    torch.cuda.empty_cache()
    n_pmg = min(n_ref, 9)  # at r=10 AMG's set-up alone takes ~100 s
    res, levels = run_2d(params_2d(n_pmg, 4, "mixed", 5, "PMG", "float"), dev, card,
                         f"2D PMG r={n_pmg} p=4 mixed/float")
    print(f"phase r: 2D PMG r={n_pmg}: coarse level p=1 with {levels[0].dofh.n_dofs} DoFs "
          f"({type(res.mg.coarse_solve).__name__}); card {card}", flush=True)
    out["pmg"] = res.n_iterations
    del res, levels
    torch.cuda.empty_cache()
    return out


def stokes_rhs(op, draw: int = 0, perturbation: int = 0) -> torch.Tensor:
    """The record's right-hand side: the ``draw``-th vector of NumPy
    default_rng(0) normals (0-based; scripts/profile_stokes_tpu.py draws the
    constant-viscosity b first and the n-sinker b second, both of this
    size), velocity masked by keep_v, pressure mean-free.  ``perturbation``
    k > 0 multiplies it by (1 + 1e-15 z), z the k-th standard normal vector
    of default_rng(99): a change at the level of roundoff."""
    n = 3 * op.n_v + op.n_p
    rng = np.random.default_rng(0)
    for _ in range(draw):
        rng.normal(size=n)
    b = rng.normal(size=n)
    b[: 3 * op.n_v] *= op.keep_v.cpu().numpy()
    b[3 * op.n_v:] -= b[3 * op.n_v:].mean()
    if perturbation:
        noise = np.random.default_rng(99)
        for _ in range(perturbation):
            z = noise.standard_normal(n)
        b *= 1.0 + 1e-15 * z
    return torch.as_tensor(b, dtype=op.dtype, device=op.keep_v.device)


def stokes_mg():
    """The Stokes records' multigrid data: Chebyshev degree 3, coarse amg."""
    from dealii_multigrid_tpu_torch.utils.params import MultigridParameters

    mg = MultigridParameters()
    mg.smoother.degree = 3
    mg.coarse_solver.type = "amg"
    return mg


def timed_fgmres(op, tri, b, reps: int, maxiter: int):
    """A warm-up FGMRES(30) to 1e-8 and ``reps`` timed ones, each fenced;
    (last result, seconds of the timed solves, counts of all solves)."""
    from dealii_multigrid_tpu_torch.solvers.gmres import gmres_solve

    g = gmres_solve(op.vmult, b, tri.vmult, m=30, maxiter=maxiter, reltol=1e-8)
    times, its = [], [g.n_iterations]
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = gmres_solve(op.vmult, b, tri.vmult, m=30, maxiter=maxiter, reltol=1e-8)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        its.append(g.n_iterations)
    return g, times, its


def phase_s(dev, card: str) -> None:
    """Stokes on the hypercube: r=2 card against CPU (block-diagonal MINRES,
    triangular FGMRES(30)); r=3 FGMRES(30) to 1e-8 in 34 iterations
    (results/stokes-nsinker-tpu.txt:8); r=5 the same solve, best of 3."""
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.models import stokes
    from dealii_multigrid_tpu_torch.solvers.gmres import gmres_solve, verify_true_residual

    mg = stokes_mg()
    sols = []
    for where in (dev, "cpu"):
        op, block, _ = stokes.build_stokes(generators.create("hypercube", 3, 2, 0), mg,
                                           device=where)
        b = stokes_rhs(op)
        x_m, it_m, _ = stokes.minres_solve(op.vmult, b, block.vmult, maxiter=500, reltol=1e-8)
        tri = stokes.triangular_preconditioner(op, block)
        g = gmres_solve(op.vmult, b, tri.vmult, m=30, maxiter=200, reltol=1e-8)
        sols.append((x_m, it_m, g.x, g.n_iterations, g.converged))
    (xm_g, im_g, xg_g, ig_g, ok_g), (xm_c, im_c, xg_c, ig_c, ok_c) = sols
    rel_m, rel_g = max_rel(xm_g, xm_c), max_rel(xg_g, xg_c)
    print(f"phase s: Stokes r=2: MINRES card {im_g} / cpu {im_c} it, x {rel_m:.3e}; FGMRES(30) card "
          f"{ig_g} / cpu {ig_c} it, x {rel_g:.3e} (limit 1e-08)", flush=True)
    check(im_g == im_c and ig_g == ig_c and ok_g and ok_c and rel_m <= 1e-8 and rel_g <= 1e-8
          and xg_g.is_cuda, "Stokes r=2: card disagrees with the CPU")
    for r, reps in ((3, 1), (5, 3)):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        op, block, _ = stokes.build_stokes(generators.create("hypercube", 3, r, 0), mg, device=dev)
        tri = stokes.triangular_preconditioner(op, block)
        b = stokes_rhs(op)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        g, times, its = timed_fgmres(op, tri, b, reps, 200)
        its = its[1:]
        n = 3 * op.n_v + op.n_p
        true = verify_true_residual(op, b, g.x, g.residual_norm, 1e-8)
        rel_true = true / float(torch.linalg.norm(b))
        best = min(times)
        print(f"phase s: Stokes r={r} triangular FGMRES(30) float64: n_dofs {n} ({3 * op.n_v} velocity "
              f"+ {op.n_p} pressure), iterations {its}, converged {g.converged}, true relative residual "
              f"{rel_true:.3e}, solve {best:.6f} s (reps {[round(t, 6) for t in times]}), "
              f"{n * its[-1] / best / 1e6:.3f} MDoF/s, setup {setup:.1f} s, "
              f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}", flush=True)
        check(g.converged and rel_true <= 1e-8 and len(set(its)) == 1,
              f"Stokes r={r}: converged {g.converged}, true relative residual {rel_true:.3e}, its {its}")
        if r == 3:
            check(n == 15_468 and its[0] == 34, f"Stokes r=3: {n} DoFs, {its} iterations (record 34)")
        else:
            check(n == 859_812, f"Stokes r=5: {n} DoFs")
        del op, block, tri, b, g
        torch.cuda.empty_cache()


def phase_t(card: str) -> None:
    """The CLI on a 2D JSON config: HMG-global r=8 p=4 with ProfilePhases;
    one row with every column, time_cg > 0."""
    from dealii_multigrid_tpu_torch import cli

    cfg = {"Type": "HMG-global", "Dim": 2, "GeometryType": "quadrant", "NRefGlobal": 8,
           "Degree": 4, "SmootherDegree": 3, "RelativeTolerance": 1e-4, "MGNumberType": "float",
           "NumberType": "float", "CoarseGridSolverType": "amg", "NRepetitions": 5,
           "ProfilePhases": True}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "input_2d.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = cli.main([path])
    print(text.getvalue(), flush=True)
    check(rc == 0, f"the CLI returned {rc} on the 2D config")
    rows = parse_last_table(text.getvalue())
    check(len(rows) == 1 and list(rows[0]) == CLI_COLUMNS, f"2D CLI table: {rows}")
    check_phase_row(rows[0], "2D HMG-global r=8", card)
    check(rows[0]["dim"] == "2", "the 2D CLI row is not dim 2")


def check_phase_row(row: dict, name: str, card: str) -> None:
    """A ProfilePhases row: every column filled and time_cg > 0.  time_cg
    is the instrumented iteration minus its phase sum, unclamped, so
    time_cg > 0 is the check that the phase sum stays below the iteration."""
    check(all(row[c] != "" for c in CLI_COLUMNS), f"CLI row {name}: an empty cell in {row}")
    check(row["converged"] == "True", f"CLI row {name}: not converged")
    keys = ("pre", "residuum", "res", "cs", "pro", "edge_pro", "post", "to_mg", "to_global")
    phase_sum = sum(float(row[f"time_{k}"]) for k in keys)
    time_cg = float(row["time_cg"])
    ratio = phase_sum / (phase_sum + time_cg)
    print(f"CLI {name}: iterations {row['n_iterations']}, time_per_it {row['time_per_it']} s (best "
          f"timed solve), in-solve phases per iteration { {k: row['time_' + k] for k in keys} } s, "
          f"sum {phase_sum:.6f} s, time_cg {time_cg:.6f} s, phase sum / instrumented iteration "
          f"{ratio:.4f}; card {card}", flush=True)
    check(time_cg > 0, f"CLI row {name}: time_cg {time_cg}")


# ---------------------------------------------------------------------------
# phases u-w (the n-sinker model, the convection demo, debug mode)
# ---------------------------------------------------------------------------

#: (least, most) FGMRES(30) iterations of the record's n-sinker rows at r=3
#: (results/stokes-nsinker-tpu.txt:10-11: 28 and 43 on the TPU).  The inner
#: Kp CG makes the preconditioner mildly nonlinear, so roundoff moves the
#: 1e6 count: from the record's b and 64 changes of it by 1e-15 relative the
#: JAX package takes 39-41 on the CPU (39 on 3 of the 65; 40 from the
#: record's b) and the port 39-41 on the CPU (tests/test_torch_nsinker.py,
#: ``nsinker_spread``); phase u prints the card's counts under 8 of them
NSINKER_R3_ITERATIONS = {1e4: (28, 28), 1e6: (39, 43)}
#: r=5 at contrast 1e6 from the record's b: the JAX package's count on the
#: CPU (``tests/test_torch_nsinker.py r5``: 108 from b and two changes of it)
NSINKER_R5_ITERATIONS = 108


@contextlib.contextmanager
def draw_clock():
    """Collect (seed, n, dtype, device, seconds) of every eigenvalue
    start-vector draw (``utils.threefry.normal``, which the estimates call
    through the module) made inside the block."""
    from dealii_multigrid_tpu_torch.utils import threefry

    real, draws = threefry.normal, []

    def timed(seed, n, dtype=torch.float32, device="cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(seed, n, dtype, device)
        torch.cuda.synchronize()
        draws.append((seed, n, dtype, out.device, time.perf_counter() - t0))
        return out

    threefry.normal = timed
    try:
        yield draws
    finally:
        threefry.normal = real


def report_draws(phase: str, name: str, draws: list, card: str) -> None:
    """Print the draws' seconds beside NumPy's ``default_rng(42)`` for the
    same entries (host draw and copy to the card: the port's draw before
    ``utils.threefry``), and hold the largest draw on the card bit for bit
    to the same draw on the CPU."""
    from dealii_multigrid_tpu_torch.utils import threefry

    check(bool(draws) and all(d[3].type == "cuda" for d in draws),
          f"{name}: no eigenvalue start vector drawn on the card {draws}")
    numpy_s = 0.0
    for _, n, dtype, _, _ in draws:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(np.random.default_rng(42).standard_normal(n), dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        numpy_s += time.perf_counter() - t0
    seed, n, dtype, dev, _ = max(draws, key=lambda d: d[1])
    on_card, on_cpu = threefry.normal(seed, n, dtype, dev), threefry.normal(seed, n, dtype, "cpu")
    same = bool(torch.equal(on_card.cpu(), on_cpu)) and not bool(torch.isnan(on_cpu).any())
    print(f"phase {phase}: {name}: {len(draws)} eigenvalue start-vector draws "
          f"{[(n, DTYPE_TAG[dt], round(sec, 4)) for _, n, dt, _, sec in draws]} take "
          f"{sum(d[4] for d in draws):.4f} s of the set-up (NumPy default_rng(42) for the same "
          f"entries: {numpy_s:.4f} s); the largest ({n} entries, {DTYPE_TAG[dtype]}) on the card "
          f"bit-equal to the CPU's: {same}; card {card}", flush=True)
    check(same, f"{name}: the threefry draw on the card differs from the CPU's")


def tensors_of(*objs) -> list:
    """Every tensor reachable from ``objs`` through dataclass fields, object
    attributes, tuples, lists and dicts."""
    import types

    seen, out, stack = set(), [], list(objs)
    while stack:
        o = stack.pop()
        if o is None or id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif dataclasses.is_dataclass(o):
            stack.extend(getattr(o, f.name) for f in dataclasses.fields(o))
        elif hasattr(o, "__dict__") and not isinstance(
                o, (type, types.ModuleType, types.FunctionType, types.MethodType)):
            stack.extend(vars(o).values())
    return out


def nsinker_row(r: int, contrast: float, reps: int, dev, card: str, perturbations: int = 0) -> int:
    """Galerkin/w-BFBT n-sinker at refinement r with the record's protocol
    (n_sinkers 4, seed 0, the second draw of default_rng(0), FGMRES(30) to
    1e-8, maxiter 300): a warm-up and ``reps`` timed solves, then one solve
    from each of ``perturbations`` changes of b at the level of roundoff
    (``stokes_rhs``), whose counts show how far roundoff moves the count.
    Returns the record's iteration count; fails unless every solve
    converged with a true relative residual <= 1e-8 and the timed solves
    took one count."""
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.models import nsinker, stokes
    from dealii_multigrid_tpu_torch.solvers.gmres import gmres_solve, verify_true_residual

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with draw_clock() as draws:
        op, block, aux = nsinker.build_stokes_nsinker(
            generators.create("hypercube", 3, r, 0), stokes_mg(),
            nsinker.nsinker_viscosity(n_sinkers=4, eta_max=contrast, seed=0),
            coarsening="galerkin", schur="wbfbt", device=dev,
        )
    tri = stokes.triangular_preconditioner(op, block)
    b = stokes_rhs(op, draw=1)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    g, times, its = timed_fgmres(op, tri, b, reps, 300)
    rel_true = verify_true_residual(op, b, g.x, g.residual_norm, 1e-8) / float(torch.linalg.norm(b))
    n = 3 * op.n_v + op.n_p
    best = min(times)
    split = {k: round(v, 3) for k, v in aux["setup_seconds"].items()}
    amg = block.p_solve.kp_solve.amg
    print(f"phase u: n-sinker r={r} contrast {contrast:g} galerkin/wbfbt FGMRES(30) float64: n_dofs {n} "
          f"({3 * op.n_v} velocity + {op.n_p} pressure), velocity levels {len(block.v_precond.mg.operators)}, "
          f"Kp AMG rows {[d['rows'] for d in amg.describe()]}, iterations {its} (warm-up first), "
          f"converged {g.converged}, true relative residual {rel_true:.3e}, solve {best:.6f} s "
          f"(reps {[round(t, 6) for t in times]}), {n * its[-1] / best / 1e6:.3f} MDoF/s, "
          f"setup {setup:.1f} s (host split {split}), peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {card}", flush=True)
    report_draws("u", f"n-sinker r={r} contrast {contrast:g}", draws, card)
    check(g.converged and rel_true <= 1e-8 and len(set(its)) == 1,
          f"n-sinker r={r} contrast {contrast:g}: converged {g.converged}, true relative residual "
          f"{rel_true:.3e}, iterations {its}")
    check(bool(torch.isfinite(g.x).all()) and g.x.is_cuda, f"n-sinker r={r}: x not finite on the card")
    if perturbations:
        spread = []
        for k in range(1, perturbations + 1):
            bk = stokes_rhs(op, draw=1, perturbation=k)
            gk = gmres_solve(op.vmult, bk, tri.vmult, m=30, maxiter=300, reltol=1e-8)
            rel_k = verify_true_residual(op, bk, gk.x, gk.residual_norm, 1e-8) / float(torch.linalg.norm(bk))
            check(gk.converged and rel_k <= 1e-8,
                  f"n-sinker r={r} contrast {contrast:g} perturbation {k}: converged {gk.converged}, "
                  f"true relative residual {rel_k:.3e}")
            spread.append(gk.n_iterations)
        print(f"phase u: n-sinker r={r} contrast {contrast:g}: counts under {perturbations} changes of b "
              f"by 1e-15 relative {spread} (the record's b: {its[0]})", flush=True)
    del op, block, aux, tri, b, g
    return its[0]


def phase_u(dev, card: str) -> None:
    """The n-sinker model: r=2 card against CPU and the device placement;
    r=3 with the record's right-hand side; r=5 at contrast 1e6."""
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.models import nsinker, stokes
    from dealii_multigrid_tpu_torch.solvers.gmres import gmres_solve

    mg = stokes_mg()
    for coarsening, schur, contrast, seed, tol in (
        ("mean", "mass", 1e2, 1, 1e-8), ("galerkin", "wbfbt", 1e4, 0, 1e-6),
    ):
        sols = []
        for where in (dev, "cpu"):
            op, block, _ = nsinker.build_stokes_nsinker(
                generators.create("hypercube", 3, 2, 0), mg,
                nsinker.nsinker_viscosity(n_sinkers=4, eta_max=contrast, seed=seed),
                coarsening=coarsening, schur=schur, device=where,
            )
            b = stokes_rhs(op)
            g = gmres_solve(op.vmult, b, stokes.triangular_preconditioner(op, block).vmult,
                            m=30, maxiter=300, reltol=1e-8)
            sols.append((g, op, block))
        (g, op, block), (g_c, _, _) = sols
        rel = max_rel(g.x, g_c.x)
        placed = tensors_of(op, block)
        off = [tuple(t.shape) for t in placed if not t.is_cuda]
        mib = sum(t.numel() * t.element_size() for t in placed) / 2**20
        print(f"phase u: n-sinker r=2 {coarsening}/{schur} contrast {contrast:g}: FGMRES(30) card "
              f"{g.n_iterations} / cpu {g_c.n_iterations} it, x {rel:.3e} (limit {tol:g}); "
              f"{len(placed)} tensors reachable from the operator and preconditioner "
              f"({mib:.2f} MiB), not on the card: {off}", flush=True)
        check(g.converged and g_c.converged and g.n_iterations == g_c.n_iterations and rel <= tol
              and g.x.is_cuda, f"n-sinker r=2 {coarsening}/{schur}: card disagrees with the CPU")
        check(not off and len(placed) >= 20, f"n-sinker r=2 {coarsening}/{schur}: tensors off the card {off}")
    for contrast, (lo, hi) in NSINKER_R3_ITERATIONS.items():
        its = nsinker_row(3, contrast, 1, dev, card, perturbations=8 if contrast == 1e6 else 0)
        check(lo <= its <= hi, f"n-sinker r=3 contrast {contrast:g}: {its} iterations, record {lo}-{hi}")
    its = nsinker_row(5, 1e6, 1, dev, card)
    check(its == NSINKER_R5_ITERATIONS,
          f"n-sinker r=5 contrast 1e6: {its} iterations, the JAX package's {NSINKER_R5_ITERATIONS}")


def phase_v(dev, card: str) -> None:
    """The convection demo: r=2 card against CPU; r=4 at constant viscosity
    and under eta = 10 exp(-3 T)."""
    from dealii_multigrid_tpu_torch.mantle_convection import demo

    (_, T, hist), (_, T_c, hist_c) = (demo.run_demo(r=2, n_steps=3, device=d) for d in (dev, "cpu"))
    its, its_c = [h["iterations"] for h in hist], [h["iterations"] for h in hist_c]
    diff = float((T.cpu() - T_c).abs().max())
    print(f"phase v: convection r=2, 3 steps: card {its} / cpu {its_c} FGMRES(60) iterations, "
          f"max |T_card - T_cpu| {diff:.3e} (limit 1e-10)", flush=True)
    check(its == its_c and diff <= 1e-10 and T.is_cuda and all(h["converged"] for h in hist),
          "convection r=2: card disagrees with the CPU")
    for label, eta_of_T, n_steps in (
        ("constant viscosity", None, 5),
        ("eta = 10 exp(-3 T)", lambda t: 10.0 * np.exp(-3.0 * t), 3),
    ):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        d = demo.build_convection_demo(4, eta_of_T=eta_of_T, device=dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        T, hist = d.run(d.T, n_steps)
        n = 3 * d.n_v + d.n_p
        for i, h in enumerate(hist):
            print(f"phase v: convection r=4 {label} step {i}: iterations {h['iterations']}, converged "
                  f"{h['converged']}, Stokes solve {h['solve_seconds']:.4f} s, rebuild "
                  f"{h['rebuild_seconds']:.4f} s, umax {h['umax']:.6e}, dt {h['dt']:.6e}, "
                  f"T in [{h['T_min']:.3e}, {h['T_max']:.12f}], wT {h['wT']:.6e}", flush=True)
        print(f"phase v: convection r=4 {label}: n_dofs {n} ({3 * d.n_v} velocity + {d.n_p} pressure), "
              f"setup {setup:.1f} s, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"card {card}", flush=True)
        check(n == 112_724, f"convection r=4: {n} DoFs")
        check(all(h["converged"] for h in hist), f"convection r=4 {label}: a step did not converge")
        check(all(-1e-10 <= h["T_min"] and h["T_max"] <= 1 + 1e-10 for h in hist),
              f"convection r=4 {label}: T left [0, 1]")
        check(hist[-1]["wT"] > hist[0]["wT"], f"convection r=4 {label}: wT did not rise")
        check(T.is_cuda and bool(torch.isfinite(T).all()), f"convection r=4 {label}: T not finite on the card")
        del d, T


def nan_in_diagonal(smoothers: tuple) -> tuple:
    """The smoothers with one NaN in the diagonal of the one below the finest."""
    sm = smoothers[-2]
    inv_diag = sm.inv_diag.clone()
    inv_diag[0] = float("nan")
    return smoothers[:-2] + (dataclasses.replace(sm, inv_diag=inv_diag), smoothers[-1])


def phase_w(dev, card: str, paths: dict) -> None:
    """Debug mode on the card: small HMG-global and HMG-local solves equal
    to the plain ones, and a NaN inside a V-cycle raises naming its phase."""
    from dealii_multigrid_tpu_torch import api
    from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG

    saved = os.environ.pop("MGTPU_DEBUG", None)
    try:
        for key, prm in (
            ("debug_hmg_global_r3", bench_params(3, 4, "double", 1)),
            ("debug_hmg_local_r3", bench_params(3, 2, "double", 1, "HMG-local")),
        ):
            os.environ.pop("MGTPU_DEBUG", None)
            plain, _, _ = api.run(prm, dev)
            os.environ["MGTPU_DEBUG"] = "1"
            (res, _problem, levels), launches = counted(lambda: api.run(prm, dev))
            publish(paths, key, launches)
            if prm.type == "HMG-global":
                entries = gc_entries(levels, prm)
            else:
                entries = ls_entries(res, levels[0], torch.float64, prm)
            check_solve(f"debug {prm.type}", res, entries, launches)
            rel = max_rel(res.x, plain.x)
            print(f"phase w: MGTPU_DEBUG=1 {prm.type} r=3 p={prm.fe_degree_fine} double: iterations "
                  f"{res.solve_iterations} (plain {plain.solve_iterations}), x vs plain {rel:.3e}, "
                  f"stencil launches {launches}; card {card}", flush=True)
            check(res.solve_iterations == plain.solve_iterations and rel <= 1e-12,
                  f"debug {prm.type}: the solve differs from the plain one")
            fine = levels[-1]
            if prm.type == "HMG-global":
                mg = dataclasses.replace(res.mg, smoothers=nan_in_diagonal(res.mg.smoothers))
                precond = PreconditionMG(mg, torch.float64)
            else:
                ls = dataclasses.replace(res.ls_mg, smoothers=nan_in_diagonal(res.ls_mg.smoothers))
                precond = api.PreconditionLS(ls, fine.op.constrained_keep, torch.float64)
            try:
                api.mg_solve(fine.op, res.rhs_used, precond, prm.mg_data, n_levels=res.n_levels,
                             n_dofs=res.n_dofs)
            except FloatingPointError as exc:  # the expected error: the check
                print(f"phase w: {prm.type} with one NaN in a smoother diagonal raises "
                      f"FloatingPointError: {exc}", flush=True)
                check("'pre'" in str(exc), f"debug {prm.type}: the error names another phase: {exc}")
            else:
                check(False, f"debug {prm.type}: a NaN inside the V-cycle raised nothing")
            del res, _problem, levels, fine, precond, plain
    finally:
        if saved is None:
            os.environ.pop("MGTPU_DEBUG", None)
        else:
            os.environ["MGTPU_DEBUG"] = saved


# ---------------------------------------------------------------------------
# phase x (bfloat16 levels and the bfloat16 instance of the stencil)
# ---------------------------------------------------------------------------


def compare_bf16(what: str, xp, KS, MS, sc, band: int) -> tuple[float, float]:
    """The bfloat16 kernel on bfloat16 inputs against a float64 stencil of
    the same (rounded) inputs, elementwise to one rounding, and against the
    plain bfloat16 version; returns (max|kernel - plain|, max|plain|)."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    got = ps.patch_stencil(xp, KS, MS, sc, band).double()
    plain = ps.patch_stencil_reference(xp, KS, MS, sc).double()
    ref64 = ps.patch_stencil_reference(*(t.double() for t in (xp, KS, MS, sc)))
    torch.cuda.synchronize()
    r64max = float(ref64.abs().max())
    err64 = (got - ref64).abs()
    ok64 = bool(torch.all(err64 <= BF16_RTOL * ref64.abs() + BF16_ATOL_REL * r64max))
    # the largest error in units of the allowance (<= 1 passes)
    used = float((err64 / (BF16_RTOL * ref64.abs() + BF16_ATOL_REL * r64max)).max())
    err_plain, pmax = float((got - plain).abs().max()), float(plain.abs().max())
    ok_plain = err_plain <= BF16_PLAIN_REL * pmax
    NP, S = xp.shape[0], KS.shape[0]
    print(f"kernel check {what} bf16 NP={NP} S={S} band={band}: vs float64 of the bf16 inputs "
          f"max_abs_err={float(err64.max()):.3e} max|ref64|={r64max:.3e} allowance used "
          f"{used:.3f} ok={ok64}; vs plain bf16 max_abs_err={err_plain:.3e} max|plain|={pmax:.3e} "
          f"({err_plain / pmax:.3e} of max, limit {BF16_PLAIN_REL:g}) ok={ok_plain}", flush=True)
    check(ok64, f"bf16 kernel beyond one rounding of the float64 stencil ({what} NP={NP} S={S})")
    check(ok_plain, f"bf16 kernel disagrees with the plain bf16 version ({what} NP={NP} S={S})")
    return err_plain, pmax


def check_kernel_bf16(dev: torch.device, measured: dict, card: str) -> None:
    """Phase x, kernel: the bfloat16 instance at phase 3's shapes (S in {9,
    17, 33} x NP in {1, 8, 512}, the six main-path shapes, degree p in {1,
    2, 3, 4, 8} with band p, random bands at S = 33), then its time at the
    six main-path shapes and the plain version's at (512, 33); fills
    ``measured["per_dtype"][torch.bfloat16]``."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    bf = torch.bfloat16
    rng = np.random.default_rng(8)

    def inputs(NP, S):
        return (torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=bf, device=dev),
                torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=bf, device=dev))

    worst = 0.0
    for S in (9, 17, 33):
        KS, MS = assembled(4, S, bf, dev)
        for NP in (1, 8, 512):
            xp, sc = inputs(NP, S)
            compare_bf16("grid", xp, KS, MS, sc, 4)
    for NP, S in MAIN_SHAPES:
        KS, MS = assembled(4, S, bf, dev)
        xp, sc = inputs(NP, S)
        worst = max(worst, compare_bf16("main-path", xp, KS, MS, sc, 4)[0])
        f32_rounded_once(xp, KS, MS, sc, 4, card)
    for NP, S in ((512, 33), (27, 9)):
        KS, MS = assembled(4, S, bf, dev)
        xp, sc = inputs(NP, S)
        buf = torch.zeros(NP * S**3 + 1, dtype=bf, device=dev)
        odd = buf[1:].view(NP, S**3)
        odd.copy_(xp)
        f32_rounded_once(odd, KS, MS, sc, 4, card, "at element offset 1")
    for p in (1, 2, 3, 4, 8):
        S = 8 * p + 1
        KS, MS = assembled(p, S, bf, dev)
        xp, sc = inputs(8, S)
        compare_bf16(f"degree p={p}", xp, KS, MS, sc, p)
    S = 33
    i, j = np.indices((S, S))
    for b in (1, 2, 3, 5, 7):
        KS, MS = (
            torch.as_tensor(np.where(abs(i - j) <= b, rng.standard_normal((S, S)), 0.0),
                            dtype=bf, device=dev)
            for _ in range(2)
        )
        check(ps.matrix_band(KS.float().cpu(), MS.float().cpu()) == b, f"random band {b} (bf16)")
        xp, sc = inputs(8, S)
        compare_bf16(f"random band b={b}", xp, KS, MS, sc, b)
    for NP, S in MAIN_SHAPES:
        KS, MS = assembled(4, S, bf, dev)
        xp, sc = inputs(NP, S)
        b_ms, b_by = bound(NP, S, KS, MS, bf)
        ms = time_shape(measured, bf, NP, S, xp, KS, MS, sc)
        measured["shapes"][(bf, NP, S)] = (ms, b_ms, b_by)
        print(f"stencil timing bf16 NP={NP} S={S}: {ms:.6f} ms, bound {1e3 * b_ms:.2f} us "
              f"({b_by}), roofline share {b_ms / ms:.4f}; f32 at this shape "
              f"{measured['shapes'][(torch.float32, NP, S)][0]:.6f} ms; card {card}", flush=True)
    ms, b_ms, b_by = measured["shapes"][(bf, 512, 33)]
    f32_ms = measured["shapes"][(torch.float32, 512, 33)][0]
    print(f"stencil NP=512 S=33: bf16 {ms:.6f} ms, f32 {f32_ms:.6f} ms in this call "
          f"(bf16 / f32 {ms / f32_ms:.4f}); card {card}", flush=True)
    measured["per_dtype"][bf].update(
        ms=ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=worst,
        shapes={f"{NP}x{S}": {"ms": measured["shapes"][(bf, NP, S)][0],
                              "roofline_share": measured["shapes"][(bf, NP, S)][1]
                              / measured["shapes"][(bf, NP, S)][0]}
                for NP, S in MAIN_SHAPES})


def f32_rounded_once(xp, KS, MS, sc, band: int, card: str, where: str = "") -> None:
    """The bfloat16 instance does the float32 instance's arithmetic and
    rounds once: its output equals, bit for bit, the float32 kernel's on
    the same values widened to float32, rounded to bfloat16."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    got = ps.patch_stencil(xp, KS, MS, sc, band)
    want = ps.patch_stencil(*(t.float() for t in (xp, KS, MS, sc)), band).to(torch.bfloat16)
    same = bool(torch.equal(got, want))
    NP, S = xp.shape[0], KS.shape[0]
    at = f" {where}" if where else ""
    print(f"kernel check bf16 NP={NP} S={S} band={band}{at}: bit-equal to the float32 kernel on "
          f"the widened inputs, rounded once: {same}; card {card}", flush=True)
    check(same, f"bf16 kernel differs from the float32 kernel rounded once (NP={NP} S={S}{at})")


@contextlib.contextmanager
def one_rounding_stencil():
    """The CPU's bfloat16 stencil rounded once, as the card's kernel rounds
    (a float64 stencil of the bfloat16 inputs, rounded to bfloat16), where
    the plain chain rounds after every contraction."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    plain = ps.patch_stencil_reference

    def once(xp, KS, MS, pscale):
        if xp.dtype != torch.bfloat16:
            return plain(xp, KS, MS, pscale)
        return plain(*(t.double() for t in (xp, KS, MS, pscale))).to(torch.bfloat16)

    ps.patch_stencil_reference = once
    try:
        yield
    finally:
        ps.patch_stencil_reference = plain


#: phase x's card-against-CPU rows at quadrant r=3 p=4: (type, MGNumberType,
#: NumberType, the JAX package's iteration count on the CPU, and the card's:
#: the JAX package's count on the CPU with its bfloat16 stencil rounded once,
#: as the kernel rounds; tests/test_torch_bf16_solve.py holds both)
BF16_SMALL = (
    ("HMG-global", "bfloat16", "float", 4, 4),
    ("HMG-global", "bfloat16", "double", 4, 4),
    ("HMG-global", "float", "float", 4, 4),
    ("HPMG", "bfloat16", "double", 4, 4),
    ("HMG-local", "bfloat16", "double", 5, 4),
)


def phase_x(dev, card: str, measured: dict, paths: dict, done: set) -> None:
    """bfloat16 levels: the kernel (check_kernel_bf16); card against CPU at
    r=3 p=4 (BF16_SMALL: the CPU's plain chain takes the JAX package's
    count, and the card takes the count of the port's CPU run whose stencil
    rounds once, as the kernel does, and the JAX package's count so rounded);
    HMG-global r=7 p=4 under float and HPMG r=7 p=4
    under mixed with bfloat16 levels, 5 repetitions each: converged, the
    guard, one count in all solves, launches per dtype as expected (the
    outer operator is float32: one launch per iteration and one for the
    guard; every other launch is bfloat16), each level's kernel check, and
    phase p's sites on the bfloat16 levels."""
    from dealii_multigrid_tpu_torch import api
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    bf = torch.bfloat16
    check_kernel_bf16(dev, measured, card)
    for mg_type, mg_number, number, n_jax, n_card in BF16_SMALL:
        prm = bench_params(3, 4, number, 1, mg_type, mg_number)
        res_gpu, _, _ = api.run(prm, dev)
        res_cpu, _, _ = api.run(prm, "cpu")
        with one_rounding_stencil():
            res_once, _, _ = api.run(prm, "cpu")
        rel = norm_rel(res_gpu.x, res_once.x)
        print(f"phase x: {mg_type} r=3 p=4 {number}/{mg_number}: card {res_gpu.solve_iterations} it, "
              f"cpu with the stencil rounded once {res_once.solve_iterations} it, cpu plain chain "
              f"{res_cpu.solve_iterations} it (JAX package on the CPU: {n_jax}, rounded once "
              f"{n_card}), x card vs cpu rounded once {rel:.3e} relative (2-norm); card {card}",
              flush=True)
        check(res_gpu.converged and res_gpu.n_iterations == res_once.n_iterations == n_card
              and res_cpu.n_iterations == n_jax,
              f"phase x: {mg_type} {number}/{mg_number} r=3: card {res_gpu.n_iterations}, cpu "
              f"rounded once {res_once.n_iterations}, cpu plain {res_cpu.n_iterations}, JAX {n_jax}, "
              f"JAX rounded once {n_card}")
        check(res_gpu.x.is_cuda and bool(torch.isfinite(res_gpu.x).all()) and rel <= 1e-2,
              f"phase x: {mg_type} {number}/{mg_number} r=3: x not finite or far from the CPU's")
    rng = np.random.default_rng(3)
    for key, mg_type, number, n_levels in (
        ("hmg_global_r7_bf16_float", "HMG-global", "float", 8),
        ("hpmg_r7_bf16_mixed", "HPMG", "mixed", 10),
    ):
        prm = bench_params(7, 4, number, 5, mg_type, "bfloat16")
        before = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (res, _problem, levels), launches = counted(lambda: api.run(prm, dev))
        per_dtype = launched_per_dtype()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        publish(paths, key, launches)
        name = f"{mg_type} r=7 {number}/bfloat16"
        check(res.n_dofs == 17_551_967 and len(levels) == n_levels
              and all(lv.op.dtype == bf for lv in levels),
              f"{name}: {res.n_dofs} DoFs, {len(levels)} levels, {[lv.op.dtype for lv in levels]}")
        entries = gc_entries(levels, prm)
        # the float32 outer operator's exchanges: its vmult per iteration,
        # the guard and the right-hand side (the bfloat16 levels launch none)
        outer_ex = levels[-1].op.exchange_plan.launches * (sum(res.solve_iterations) + 2)
        check_solve(name, res, entries, launches, extra_exchanges=outer_ex)
        its = res.solve_iterations
        outer = sum(its) + 1
        expect = {torch.float32: outer, bf: expected_launches(entries, its) - outer}
        for k, n in warmup_launches().items():
            expect[k] = expect.get(k, 0) + n
        print(f"{name}: launches per dtype { {DTYPE_TAG[k]: v for k, v in per_dtype.items()} } "
              f"(expected { {DTYPE_TAG[k]: v for k, v in expect.items()} })", flush=True)
        check(per_dtype == expect, f"{name}: launches per dtype {per_dtype} != {expect}")
        paths[key + "_bf16"] = per_dtype[bf]
        print(f"{name}: n_dofs {res.n_dofs}, levels {len(levels)}, iterations {its} (float "
              f"levels: 3 HMG-global, 4 HPMG), solve {res.time:.6f} s "
              f"(reps {[round(t, 6) for t in res.time_per_rep]}), {res.throughput / 1e6:.3f} MDoF/s, "
              f"setup {res.setup_time:.1f} s, run wall {wall:.1f} s, peak mem {peak:.2f} GiB "
              f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)
        hybrid_sites(levels, res.mg, done, card, f"{name} finest levels",
                     p_transfer=mg_type == "HPMG")
        check_levels(name, entries, res.n_iterations, card, rng)
        del res, _problem, levels, entries
        torch.cuda.empty_cache()


#: the record phase y holds the runner to, in the repository
SMALL_SCALING_RECORD = os.path.join("results", "small-scaling-quadrant-tpu-merged.txt")


def phase_y(card: str, paths: dict) -> None:
    """The port's experiment runner on the card: small-scaling quadrant up
    to r=4 (8 rows: r=3-4, p in {1, 4}, HMG-local and HMG-global), held
    to the TPU record's iteration counts; every row equal, none failed, the
    artifact's header and device column name the card."""
    from dealii_multigrid_tpu_torch.tools import run_experiment as rx

    record = os.path.join(os.path.dirname(os.path.abspath(__file__)), SMALL_SCALING_RECORD)
    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            sweep, launches = counted(lambda: rx.run_experiment(
                "small-scaling", ["quadrant"], "cuda:0", os.path.join(tmp, "ss.txt"), max_ref=4,
                against=[record], repetitions=1,
            ))
        with open(sweep.out_path) as f:
            head = f.readline().rstrip("\n")
    publish(paths, "runner_small_scaling_r4", launches)
    for _, cfg, _, text in sweep.verdicts:
        print(f"phase y: {cfg} {text}", flush=True)
    print(f"phase y: {len(sweep.ran)} ran in {sum(t for _, t in sweep.ran):.1f} s, "
          f"{len(sweep.failed)} failed, {sweep.count('equal')} equal to {SMALL_SCALING_RECORD}, "
          f"{sweep.count('differs')} differ, stencil launches {launches}; artifact header "
          f"{head!r}; card {card}", flush=True)
    check(len(sweep.ran) == 8 and not sweep.failed, f"phase y: {len(sweep.ran)} rows ran, failed "
          f"{sweep.failed}")
    check(sweep.count("equal") == 8, "phase y: a row's count is not the record's")
    check(head.startswith(f"# device: {card} |"), f"phase y: artifact header {head!r}")
    check(all(row["device"] == card for row in sweep.rows), "phase y: a row's device column")
    check(launches > 0, "phase y: the runner launched no stencil")


PARTITIONING_RECORD = os.path.join("results", "large-scaling-partitioning-virtual8.txt")


def phase_y_partitioning(card: str, paths: dict) -> None:
    """The runner on large_scaling_partitioning 8,1 at r=4 (its first
    refinement), degree 4 (6 rows: HMG-local, HMG-global and HMG-global
    FirstChildPolicy, each with NShards 8 and 1) against the
    virtual-8-device record: every row the record's count, none failed, and
    each NShards 8 row (8 ranks sharing the card) the record's partition
    columns."""
    from dealii_multigrid_tpu_torch.tools import run_experiment as rx

    record = os.path.join(os.path.dirname(os.path.abspath(__file__)), PARTITIONING_RECORD)
    with tempfile.TemporaryDirectory() as tmp:
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            sweep, launches = counted(lambda: rx.run_experiment(
                "large_scaling_partitioning", ["8,1"], "cuda:0", os.path.join(tmp, "lsp.txt"),
                max_ref=4, against=[record], degrees=[4], repetitions=1,
            ))
    publish(paths, "runner_partitioning_r4_p4", launches)
    for _, cfg, _, text in sweep.verdicts + sweep.partitions:
        print(f"phase y: {cfg} {text}", flush=True)
    n_part = sum(v == "equal" for _, _, v, _ in sweep.partitions)
    print(f"phase y: seconds per row {[(nm, round(t, 1)) for nm, t in sweep.ran]}", flush=True)
    print(f"phase y: large_scaling_partitioning 8,1: {len(sweep.ran)} ran in "
          f"{sum(t for _, t in sweep.ran):.1f} s, {len(sweep.failed)} failed, "
          f"{sweep.count('equal')} counts equal to {PARTITIONING_RECORD}, {n_part} of "
          f"{len(sweep.partitions)} sharded rows' partitions equal; card {card}", flush=True)
    check(len(sweep.ran) == 6 and not sweep.failed,
          f"phase y: {len(sweep.ran)} partitioning rows ran, failed {sweep.failed}")
    check(sweep.count("equal") == 6, "phase y: a partitioning row's count is not the record's")
    check(len(sweep.partitions) == 3 and n_part == 3,
          "phase y: a sharded row's partition columns are not the record's")


SHARDED_TARGET = "dealii_multigrid_tpu_torch.parallel.sharding:run_cases"


def rank_expected_launches(info: dict, prm) -> int:
    """Stencil launches one rank of a sharded HMG-global solve implies, from
    its own levels (``gc_entries`` on the rank's operators: a sharded level
    launches on the rank's NP / D patches, a replicated one on all)."""
    deg = prm.mg_data.smoother.degree
    eig = prm.mg_data.smoother.eig_cg_n_iterations
    lv = info["levels"]
    live = [l for l in range(1, len(lv)) if lv[l]["NP"] > 0]
    per_it = sum(2 * deg + (1 if l == len(lv) - 1 else 0) for l in live)
    n = sum(info["solve_iterations"]) * per_it + eig * len(live)
    return n + (1 if lv[-1]["NP"] > 0 else 0)


def check_rank_kernels(name: str, ranks: list, rng) -> list:
    """The kernel against its plain version at every rank-local (NP, S) of a
    sharded path, on the rank's own KS, MS and pscale (float32); returns
    the distinct shapes."""
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps

    shapes = {}
    for info in ranks:
        for lv in info["levels"]:
            if lv["NP"] > 0:
                shapes.setdefault((lv["NP"], lv["S"], lv["band"]), lv)
    for (NP, S, band), lv in sorted(shapes.items()):
        KS, MS, sc = (lv[k].to("cuda", torch.float32).contiguous() for k in ("KS", "MS", "pscale"))
        xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=torch.float32, device="cuda")
        got = ps.patch_stencil(xp, KS, MS, sc, band)
        ref = ps.patch_stencil_reference(xp, KS, MS, sc)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rmax = float(ref.abs().max())
        ok = bool(torch.all((got - ref).abs() <= F32_ATOL_REL * rmax + F32_RTOL * ref.abs()))
        print(f"{name} rank-local kernel check f32 NP={NP} S={S} band={band}: "
              f"max_abs_err={err:.3e} max|ref|={rmax:.3e} ok={ok}", flush=True)
        check(ok, f"{name}: the kernel disagrees with the plain version at NP={NP} S={S}")
    return sorted(shapes)


def phase_z(card: str, paths: dict, x_b: torch.Tensor, rng) -> None:
    """Sharded solves through the port's launcher, every rank on cuda:0
    (ranks sharing one card talk over gloo; nothing here is a multi-GPU
    speed).

    z1 (and z3): the main path, HMG-global quadrant r=7 p=4 float over 4
    ranks, 3 repetitions, then two more solves on the same hierarchy: 3
    iterations on every rank, the guard, x within 1e-5 of phase b's, each
    rank's stencil launches equal to its own levels' count, the kernel at
    every rank-local shape, per rank its peak memory, set-up and the L7
    ghost slots imported per vmult below 10% of the owned slots; z3: the
    three float32 solves' x bit for bit equal on every rank.
    z2: the JAX package's dryrun configuration (quadrant p=3, double, rtol
    1e-10, coarse amg, sharding.py:295-467; r=4 where the JAX package runs
    r=5, to keep the script inside its time limit) over 8 ranks: HMG-global
    with the Morton default partition and with CellWeightPolicy-2.0
    (Gaussian right-hand side), HMG-local with per-level partitions; each
    within 1e-12 of the one-rank card solve with equal counts."""
    from dealii_multigrid_tpu_torch.parallel import sharding
    from dealii_multigrid_tpu_torch.parallel.launch import launch

    prm = bench_params(7, 4, "float", 3)
    t0 = time.perf_counter()
    out = launch(SHARDED_TARGET, [{"params": prm, "repeat": 2}], 4, "cuda", timeout=900)
    z1 = out[0]
    wall = time.perf_counter() - t0
    ranks = z1["ranks"]
    print(f"z1: HMG-global r=7 p=4 float over {len(ranks)} ranks, backend "
          f"{ranks[0]['backend']}, devices {[r['device'] for r in ranks]}; wall {wall:.1f} s; "
          f"card {card}", flush=True)
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks),
          "z1: a rank is not on cuda:0 over gloo")
    check(z1["converged"] and z1["true_residual"] <= z1["guard_threshold"], "z1: converged / guard")
    rel_b = float(np.linalg.norm(z1["x"] - x_b.double().numpy()) / np.linalg.norm(x_b.double().numpy()))
    print(f"z1: solve iterations {z1['solve_iterations']}, x vs phase b {rel_b:.3e}, true residual "
          f"{z1['true_residual']:.4e} (allowance {z1['guard_threshold']:.4e})", flush=True)
    check(rel_b <= 1e-5, f"z1: x differs from phase b's by {rel_b:.3e}")
    for info in ranks:
        expect = rank_expected_launches(info, prm)
        fine = info["levels"][-1]
        share = fine["ghosts"] / fine["owned"]
        paths[f"sharded_hmg_global_r7_float_rank{info['rank']}"] = info["launches"]
        print(f"z1 rank {info['rank']}: solve iterations {info['solve_iterations']}, stencil "
              f"launches {info['launches']} (expected {expect}), levels (NP, S, shards) "
              f"{[(l['NP'], l['S'], l['n_shards']) for l in info['levels']]}, set-up "
              f"{info['setup_time']:.1f} s, peak mem {info['peak_gib']:.2f} GiB, L7 owned slots "
              f"{fine['owned']}, ghost slots imported per vmult {fine['ghosts']} "
              f"({100 * share:.2f}%); card {card}", flush=True)
        check(all(n == 3 for n in info["solve_iterations"]), f"z1 rank {info['rank']}: not 3 iterations")
        check(info["launches"] == expect, f"z1 rank {info['rank']}: launches {info['launches']} != {expect}")
        check(share < 0.10, f"z1 rank {info['rank']}: ghosts {100 * share:.2f}% of owned on L7")
    check_rank_kernels("z1", ranks, rng)
    print(f"z3: three float32 sharded solves bit-equal: {z1['repeat_equal']}", flush=True)
    check(z1["repeat_equal"] is True, "z3: the float32 sharded solves are not bit-repeatable")
    del out, z1

    t0 = time.perf_counter()
    # both of the JAX package's dryruns in one launch of 8 ranks
    rows = sharding.dryrun(sharding.dryrun_configurations(n_ref=4), 8)
    wall = time.perf_counter() - t0
    for p, rel, it_sharded, it_one in rows:
        name = f"z2 {p.type} {p.policy_name or 'Morton default'}"
        print(f"{name}: 8 ranks {it_sharded} iterations, one rank {it_one}; x vs one rank "
              f"{rel:.3e} (JAX measured 8.652e-16 at r=5, MULTICHIP_r05.json); card {card}",
              flush=True)
        check(it_sharded == it_one, f"{name}: counts {it_sharded} != {it_one}")
        check(rel <= 1e-12, f"{name}: x differs from the one-rank card solve by {rel:.3e}")
    print(f"z2: 8 ranks, three solves in one launch: wall {wall:.1f} s; card {card}", flush=True)


def new_phases(dev, card: str, done: set, n_ref_2d: int) -> dict:
    """Phases q, r, s, t, in that order (phase p runs inside b, d and r)."""
    phase_q(dev, card)
    stamp("r")
    its = phase_r(dev, card, n_ref_2d, done)
    stamp("s")
    phase_s(dev, card)
    stamp("t")
    phase_t(card)
    return its


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
    from dealii_multigrid_tpu_torch.utils.phases import GRAPHS

    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)} ({card})",
          flush=True)

    stamp("2 (build)")
    # 2. build
    secs = ps.library.build()
    print(f"kernel build: {secs:.1f} s -> {ps.library.path}", flush=True)
    if ps.library.build_log.strip():
        print(ps.library.build_log.strip(), flush=True)

    done: set = set()  # phase p's sites

    stamp("3")
    # 3. kernel against the plain version
    measured = check_kernel(dev)
    stamp("3c")
    # 3c. the Chebyshev step kernel against the eager chain
    steps = check_chebyshev_step(dev, card)
    rng = np.random.default_rng(1)

    stamp("3d")
    # 3d. the exchange kernel against the eager chain at hypercube r=6 p=4's
    # finest level (512 x 33^3 slots, patches only)
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.ops import assembly_exchange as ax
    from dealii_multigrid_tpu_torch.ops.hybrid import make_hybrid_operator

    print(f"exchange kernel build: {ax.library.build():.1f} s -> {ax.library.path}", flush=True)
    lv6 = api.build_level_hybrid(generators.create("hypercube", 3, 6), 4, dev, torch.float32)
    exchange_rows = {(torch.float32, "hypercube r=6 L6"): check_exchange("hypercube r=6 L6", lv6.op, card)}
    op64 = make_hybrid_operator(lv6.fmt, lv6.hanging, dev, torch.float64)
    exchange_rows[(torch.float64, "hypercube r=6 L6")] = check_exchange("hypercube r=6 L6", op64, card)
    del lv6, op64
    torch.cuda.empty_cache()

    stamp("4a")
    # 4a. small solve on the card against the same solve on the CPU
    small = bench_params(3, 2, "double", 1)
    res_gpu, _, _ = api.run(small, dev)
    res_cpu, _, _ = api.run(small, "cpu")
    rel = max_rel(res_gpu.x, res_cpu.x)
    print(f"small solve r=3 p=2 double: card {res_gpu.n_iterations} it, cpu {res_cpu.n_iterations} it, "
          f"max rel diff {rel:.3e}", flush=True)
    check(res_gpu.n_iterations == res_cpu.n_iterations and rel <= 1e-8,
          "card solve disagrees with the CPU solve at r=3 p=2")

    stamp("4b")
    # 4b. the main path: quadrant r=7 p=4, float, 5 repetitions
    prm = bench_params(7, 4, "float", 5)
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (result, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    wall = time.perf_counter() - t0
    paths: dict = {}
    publish(paths, "hmg_global_r7_float", launches)
    paths["hmg_global_r7_float_f32"] = launched_per_dtype().get(torch.float32, 0)
    check(set(launched_per_dtype("chebyshev_step")) == {torch.float32},
          f"the main path's step kernel launches per dtype {launched_per_dtype('chebyshev_step')}")
    print(f"levels (NP, S, NS, use_cross): {[(lv.op.NP, lv.op.S, lv.op.NS, lv.op.use_cross) for lv in levels]}",
          flush=True)
    entries = gc_entries(levels, prm)
    check_solve("HMG-global r=7 float", result, entries, launches, n_it=3)
    print(f"HMG-global quadrant r=7 p=4 float: n_dofs {result.n_dofs}, iterations {result.n_iterations}, "
          f"solve {result.time:.6f} s (reps {[round(t, 6) for t in result.time_per_rep]}), "
          f"{result.throughput / 1e6:.3f} MDoF/s, setup {result.setup_time:.1f} s, "
          f"run wall {wall:.1f} s, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)
    # phase p after the peak's reading: its 20 right-hand sides are not the run's
    hybrid_sites(levels, result.mg, done, card, "main path L7/L6", p_transfer=False)
    # 3d on the main path's levels: L5 and L7 in float32, L7 in float64
    for l in (5, 7):
        exchange_rows[(torch.float32, f"quadrant r=7 L{l}")] = check_exchange(
            f"quadrant r=7 L{l}", levels[l].op, card)
    op64 = make_hybrid_operator(levels[7].fmt, levels[7].hanging, dev, torch.float64)
    exchange_rows[(torch.float64, "quadrant r=7 L7")] = check_exchange("quadrant r=7 L7", op64, card)
    del op64

    # 5 (main path). per patch level: kernel time x launches per solve against the bound
    shapes = [(e.op.NP, e.op.S) for e in entries if e.op.NP > 0]
    check(shapes == list(MAIN_SHAPES), f"patch level shapes {shapes} != {MAIN_SHAPES}")
    check(all(lv.op.band == 4 for lv in levels), "an operator's band is not p = 4")
    total = 0.0
    for label, op, per_iteration, *_ in entries:
        if op.NP == 0:
            continue
        n = per_iteration * result.n_iterations
        ms, b_ms, b_by = measured["shapes"][(torch.float32, op.NP, op.S)]
        total += n * ms
        print(f"{label} NP={op.NP} S={op.S}: {n} launches per solve x {ms:.6f} ms = {n * ms:.4f} ms; "
              f"bound {1e3 * b_ms:.2f} us ({b_by}), roofline share {b_ms / ms:.4f}; card {card}",
              flush=True)
    print(f"stencil per solve: {total:.4f} ms of kernel time; card {card}", flush=True)
    # phase z holds its sharded solve to this x
    x_b = result.x.detach().cpu()
    # release every reference to the hierarchy: the next phases' peaks
    # must not include it
    del result, _problem, levels, entries, op
    torch.cuda.empty_cache()

    stamp("4c")
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

    stamp("4d")
    # 4d. HPMG quadrant r=7 p=4, mixed outer CG around float levels
    prm = bench_params(7, 4, "mixed", 5, "HPMG", "float")
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (res_m, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    wall = time.perf_counter() - t0
    publish(paths, "hpmg_r7_mixed", launches)
    check(len(levels) == 10 and [lv.degree for lv in levels[-3:]] == [1, 2, 4],
          f"HPMG r=7 p=4 plan: {[(lv.degree, lv.mesh.n_cells) for lv in levels]}")
    entries = gc_entries(levels, prm)
    check_solve("HPMG r=7 mixed", res_m, entries, launches)
    hybrid_sites(levels, res_m.mg, done, card, "HPMG r=7 L10/L9 (p=4 from p=2)", p_transfer=True)
    print(f"HPMG quadrant r=7 p=4 mixed/float: n_dofs {res_m.n_dofs}, levels {len(levels)}, "
          f"iterations {res_m.n_iterations} (records: 4 at r=4-6), solve {res_m.time:.6f} s "
          f"(reps {[round(t, 6) for t in res_m.time_per_rep]}), {res_m.throughput / 1e6:.3f} MDoF/s, "
          f"setup {res_m.setup_time:.1f} s, run wall {wall:.1f} s, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)

    stamp("4e")
    # 4e. df32 on the same hierarchy: the f64 RHS split exactly into a pair
    fine = levels[-1]
    b_pair = twofloat.tf_split_f64_host(res_m.rhs_used)
    # the peak of the solve phase alone (d's peak includes its set-up)
    torch.cuda.reset_peak_memory_stats()
    res_d, launches = counted(lambda: api.mg_solve(
        fine.op, b_pair, PreconditionMG(res_m.mg, torch.float32), prm.mg_data,
        n_levels=len(levels), n_dofs=fine.dofh.n_dofs,
    ))
    publish(paths, "hpmg_r7_df32", launches)
    res_d.x = fine.to_global(res_d.x)
    check_solve("HPMG r=7 df32", res_d, entries, launches, setup=False, cycles=(res_m.mg,))
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

    stamp("4f")
    # 4f. PMG quadrant r=5 p=4 mixed: dense coarse solve on the fine mesh at p=1
    prm = bench_params(5, 4, "mixed", 5, "PMG", "float")
    (res_p, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    publish(paths, "pmg_r5_mixed", launches)
    entries = gc_entries(levels, prm)
    check_solve("PMG r=5 mixed", res_p, entries, launches)
    print(f"PMG quadrant r=5 p=4 mixed/float: n_dofs {res_p.n_dofs}, levels {len(levels)}, coarse "
          f"{levels[0].dofh.n_dofs} DoFs, iterations {res_p.n_iterations} (record: 4), "
          f"solve {res_p.time:.6f} s, {res_p.throughput / 1e6:.3f} MDoF/s, setup {res_p.setup_time:.1f} s; "
          f"card {card}", flush=True)
    check_levels("PMG r=5", entries, res_p.n_iterations, card, rng)
    del res_p, _problem, levels, entries
    torch.cuda.empty_cache()

    stamp("4g")
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

    stamp("4h, 4i")
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
        publish(paths, key, launches)
        paths[key + "_f64"] = launched_per_dtype().get(torch.float64, 0)
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

    stamp("4j")
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

    stamp("4k")
    # 4k. PMG quadrant r=6 p=4 mixed over float levels, AMG on the fine mesh at p=1
    prm = bench_params(6, 4, "mixed", 5, "PMG", "float")
    before = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (res_k, _problem, levels), launches = counted(lambda: api.run(prm, dev))
    wall = time.perf_counter() - t0
    publish(paths, "pmg_r6_mixed_amg", launches)
    check([lv.degree for lv in levels] == [1, 2, 4] and levels[0].dofh.n_dofs == 38_402
          and res_k.n_dofs == 2_305_421,
          f"PMG r=6 p=4 plan: {[(lv.degree, lv.dofh.n_dofs) for lv in levels]}")
    entries = gc_entries(levels, prm)
    check_solve("PMG r=6 mixed amg", res_k, entries, launches)
    amg_k = amg_of(res_k.mg.coarse_solve)
    check(len(amg_k.levels) >= 2 and amg_k.levels[0].A.shape[0] == 38_402,
          "PMG r=6: the coarse solve is not AMG on the p=1 fine mesh")
    print_amg("PMG r=6", amg_k, card)
    print(f"PMG quadrant r=6 p=4 mixed/float coarse amg: n_dofs {res_k.n_dofs}, levels {len(levels)}, "
          f"coarse {levels[0].dofh.n_dofs} DoFs, iterations {res_k.n_iterations}, solve {res_k.time:.6f} s "
          f"(reps {[round(t, 6) for t in res_k.time_per_rep]}), {res_k.throughput / 1e6:.3f} MDoF/s, "
          f"setup {res_k.setup_time:.1f} s, run wall {wall:.1f} s, "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(allocated before the run {before:.2f} GiB); card {card}", flush=True)
    check_levels("PMG r=6", entries, res_k.n_iterations, card, rng)

    stamp("4l")
    # 4l. other coarse types on k's hierarchy (the outer operator, the
    # right-hand side, transfers and smoothers are k's)
    fine = levels[-1]
    outer_op = api.MixedPrecisionOperator(fine.op)
    prm_l = bench_params(6, 4, "mixed", 2, "PMG", "float", n_cycles=2)
    for kind in ("cg_with_amg", "amg_petsc"):
        t0 = time.perf_counter()
        coarse = api._hybrid_coarse_solver(kind, levels[0], prm_l.mg_data)
        counter = None
        if kind == "cg_with_amg":
            counter = CountingOp(coarse.op)
            coarse = dataclasses.replace(coarse, op=counter)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        print_amg(f"PMG r=6 coarse {kind}", amg_of(coarse), card)
        mg_l = dataclasses.replace(res_k.mg, coarse_solve=coarse)
        res_l, launches = counted(lambda: api.mg_solve(
            outer_op, res_k.rhs_used, PreconditionMG(mg_l, torch.float64), prm_l.mg_data,
            n_levels=len(levels), n_dofs=fine.dofh.n_dofs,
        ))
        publish(paths, f"pmg_r6_mixed_{kind}", launches)
        res_l.x = fine.to_global(res_l.x)
        extra = counter.calls if counter is not None else 0
        check_solve(f"PMG r=6 mixed {kind}", res_l, entries, launches, setup=False,
                    extra_launches=extra, cycles=(mg_l,),
                    extra_exchanges=extra * exchange_launches_of(counter.op) if extra else 0)
        rel = norm_rel(res_l.x, res_k.x)
        print(f"PMG quadrant r=6 p=4 mixed/float coarse {kind} (cycles {prm_l.mg_data.coarse_solver.n_cycles}) "
              f"on the same hierarchy: iterations {res_l.solve_iterations} (amg: {res_k.n_iterations}), "
              f"coarse-CG operator applications in the run {extra}, x vs amg {rel:.3e} relative, "
              f"solve {res_l.time:.6f} s (reps {[round(t, 6) for t in res_l.time_per_rep]}), "
              f"coarse build {t_build:.1f} s; card {card}", flush=True)
        check(rel <= 1e-3, f"coarse {kind} disagrees with coarse amg on the PMG r=6 hierarchy")
        del coarse, counter, mg_l, res_l
    del res_k, amg_k, fine, outer_op, _problem, levels, entries
    torch.cuda.empty_cache()

    stamp("4m")
    # 4m. truncated HPMG quadrant r=6 p=4 (MinLevel 7: the fine mesh only),
    # double over float levels, beside the records' iteration counts
    for coarse, n_cycles, record in (
        ("amg", 1, 5), ("amg", 2, 4), ("amg", 3, 4), ("amg", 4, 4), ("amg_petsc", 2, 8),
    ):
        prm = bench_params(6, 4, "double", 2, "HPMG", "float", coarse, n_cycles, 7)
        torch.cuda.reset_peak_memory_stats()
        (res, _problem, levels), launches = counted(lambda: api.run(prm, dev))
        key = f"hpmg_r6_trunc_{coarse}_{n_cycles}"
        publish(paths, key, launches)
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

    stamp("4n")
    # 4n. AMG and AMGPETSc alone on quadrant r=6 p=1, double (gather engine:
    # no stencil launch)
    for mg_type in ("AMG", "AMGPETSc"):
        prm = bench_params(6, 1, "double", 3, mg_type, "double")
        torch.cuda.reset_peak_memory_stats()
        (res, _problem, levels), launches = counted(lambda: api.run(prm, dev))
        its = res.solve_iterations
        amg = amg_of(res.amg)
        print_amg(f"{mg_type} r=6 p=1", amg, card)
        print(f"{mg_type} quadrant r=6 p=1 double: n_dofs {res.n_dofs}, solve iterations {its}, "
              f"loop residual {res.residual_norm:.4e}, true residual {res.true_residual:.4e} "
              f"(allowance {res.guard_threshold:.4e}), solve {res.time:.6f} s "
              f"(reps {[round(t, 6) for t in res.time_per_rep]}), {res.throughput / 1e6:.3f} MDoF/s, "
              f"setup {res.setup_time:.1f} s, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
              f"stencil launches {launches}; card {card}", flush=True)
        check(res.converged and len(set(its)) == 1 and res.n_dofs == 38_402 and res.n_levels == 1,
              f"{mg_type} r=6 p=1: converged {res.converged}, iterations {its}")
        check(res.true_residual <= res.guard_threshold, f"{mg_type} r=6 p=1: true-residual guard failed")
        check(launches == 0, f"{mg_type} runs on the gather engine but launched the stencil")
        check(len(amg.levels) >= 2 and bool(torch.isfinite(res.x).all()) and res.x.is_cuda,
              f"{mg_type} r=6 p=1: not an AMG solve on the card")
        del res, _problem, levels, amg
        torch.cuda.empty_cache()

    stamp("4o")
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
    publish(paths, "cli_hmg_global_and_pmg_r7", launches)
    check(rc == 0, f"the CLI returned {rc}")
    rows = parse_last_table(text.getvalue())
    check(len(rows) == 2 and list(rows[0]) == CLI_COLUMNS,
          f"CLI table: {len(rows)} rows, columns {list(rows[0]) if rows else None}")
    for row, mg_type, n_levels in zip(rows, ("HMG-global", "PMG"), (8, 3)):
        check(all(row[c] != "" for c in CLI_COLUMNS), f"CLI row {mg_type}: an empty cell in {row}")
        check(row["type"] == mg_type and row["n_dofs"] == "17551967"
              and int(row["n_levels"]) == n_levels, f"CLI row {mg_type}: {row}")
        check_phase_row(row, f"{mg_type} r=7 p=4", card)
    check(int(rows[0]["n_iterations"]) == 3, f"CLI HMG-global r=7: iterations {rows[0]['n_iterations']}")
    check(launches > 0, "the CLI runs launched no stencil")
    check(STEP_PATHS["cli_hmg_global_and_pmg_r7"] > 0, "the CLI runs launched no Chebyshev step kernel")
    torch.cuda.empty_cache()

    stamp("4p-4t")
    # 4p-4t. 2D on the gather engine, Stokes, the 2D CLI; phase p's sites
    its_2d = new_phases(dev, card, done, 9)
    print(f"2D r=9 iterations {its_2d}", flush=True)

    stamp("4u-4w")
    # 4u-4w. the n-sinker model and the convection demo (no stencil), debug mode
    for key, phase in (("nsinker", phase_u), ("convection", phase_v)):
        stamp(key)
        _, launches = counted(lambda: phase(dev, card))
        publish(paths, key, launches)
        check(launches == 0, f"phase {key} launched the stencil {launches} times")
    stamp("w")
    phase_w(dev, card, paths)

    stamp("4x, 4y")
    # 4x, 4y. bfloat16 levels and the bfloat16 instance; the experiment runner
    phase_x(dev, card, measured, paths, done)
    check(done == set(P_SITES) | set(P_SITES_BF16), f"phase p covered {sorted(done)}")
    stamp("y")
    phase_y(card, paths)
    phase_y_partitioning(card, paths)

    stamp("z")
    # 4z. sharded solves: ranks sharing the card over gloo
    phase_z(card, paths, x_b, rng)

    stamp("result lines")
    # result lines: one entry per instance of the kernel, each with the
    # launches of the path that runs it in that dtype (f32: the main path b;
    # f64: h's double outer operator; bf16: x's HMG-global r=7)
    main_path = {torch.float32: paths["hmg_global_r7_float_f32"],
                 torch.float64: paths["hmg_local_r7_f64"],
                 torch.bfloat16: paths["hmg_global_r7_bf16_float_bf16"]}
    kernels = []
    for dtype, m in measured["per_dtype"].items():
        tag = DTYPE_TAG[dtype]
        kernels.append({
            # the float32 instance keeps the kernel's original name
            "name": "patch_stencil" if dtype == torch.float32 else f"patch_stencil_{tag}",
            "route": "cuda",
            "source": "dealii_multigrid_tpu_torch/csrc/patch_stencil.cu",
            "replaces": "dealii_multigrid_tpu/ops/pallas_stencil.py:71",
            "launches": main_path[dtype],
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "roofline_share": m["bound_ms"] / m["ms"],
            "library_ms": None,  # no single PyTorch call computes this function
        })
        if dtype == torch.bfloat16:
            kernels[-1]["shapes"] = m["shapes"]
    kernels[0]["launches_per_path"] = paths
    # the step kernel's launches: f32 in the main path b, f64 in w's HMG-global
    # r=3 double (no full-size path smooths in float64)
    step_path = {torch.float32: "hmg_global_r7_float", torch.float64: "debug_hmg_global_r3"}
    for dtype, by_step in steps.items():
        ms, plain_ms, bound_ms, _ = by_step["recurrence"]
        kernels.append({
            "name": f"chebyshev_step_{DTYPE_TAG[dtype]}",
            "route": "cuda",
            "source": "dealii_multigrid_tpu_torch/csrc/chebyshev_step.cu",
            "replaces": "the smoother's eager chain, solvers/chebyshev.py (no TPU kernel)",
            "launches": STEP_PATHS[step_path[dtype]],
            "max_abs_err": max(err for *_, err in by_step.values()),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "roofline_share": bound_ms / ms,
            "library_ms": None,
        })
    kernels[-2]["launches_per_path"] = STEP_PATHS
    # the exchange kernel: at hypercube r=6's L6 (and the other levels of
    # 3d); f32 launches in the main path b, f64 in w's HMG-global r=3 double
    exchange_path = {torch.float32: "hmg_global_r7_float", torch.float64: "debug_hmg_global_r3"}
    for dtype in (torch.float32, torch.float64):
        ms, plain_ms, bound_ms, err = exchange_rows[(dtype, "hypercube r=6 L6")]
        kernels.append({
            "name": f"assembly_exchange_{DTYPE_TAG[dtype]}",
            "route": "cuda",
            "source": "dealii_multigrid_tpu_torch/csrc/assembly_exchange.cu",
            "replaces": "the exchange's eager chain, ops/assembly_exchange.py (no TPU kernel)",
            "launches": EXCHANGE_PATHS[exchange_path[dtype]],
            "max_abs_err": max(row[3] for (k, _), row in exchange_rows.items() if k == dtype),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes",
            "roofline_share": bound_ms / ms,
            "library_ms": None,
            "levels": {label: row[:3] for (k, label), row in exchange_rows.items() if k == dtype},
        })
    kernels[-2]["launches_per_path"] = EXCHANGE_PATHS
    print(f"[chip_smoke] seconds per phase {json.dumps(phase_seconds())}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }, "vcycle_graphs": GRAPHS.summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
