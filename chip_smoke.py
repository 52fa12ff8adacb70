"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing falls back to the CPU):
  1. set up: require a CUDA card, keep float32 contractions out of TF32;
  2. build the patch-stencil kernel from dealii_multigrid_tpu_torch/csrc;
  3. check the kernel against its plain PyTorch version on the card
     (S in {9, 17, 33}, NP in {1, 8, 512}, float32 and float64) and time
     both at NP = 512, S = 33;
  4. solve: the HMG-global quadrant r=7 p=4 configuration (17,551,967 DoFs,
     float levels, Chebyshev degree 3, CG to rtol 1e-4) through api.run on
     cuda:0 with 5 repetitions; checks convergence in 3 iterations, the
     recomputed-residual guard, that every patch apply went through the
     kernel, and a small double-precision solve on the card against the
     same solve on the CPU (plain stencil path);
  5. print the kernels line, the card's name and power limit, and the
     result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

F32_RTOL, F32_ATOL_REL = 2e-5, 2e-4   # f32: atol = 2e-4 * max|ref|
F64_REL = 1e-12                        # f64: max|err| / max|ref|
TIMED_LAUNCHES = 50


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bench_params(n_ref: int, degree: int, number: str, reps: int):
    from dealii_multigrid_tpu_torch.utils.params import RunParameters

    prm = RunParameters()
    prm.type = "HMG-global"
    prm.geometry_type = "quadrant"
    prm.n_ref_global = n_ref
    prm.fe_degree_fine = degree
    prm.number_type = number
    prm.mg_number_type = number
    prm.mg_data.coarse_solver.type = "amg"
    prm.mg_data.smoother.degree = 3
    prm.mg_data.cg_normal.reltol = 1e-4
    prm.mg_data.n_repetitions = reps
    return prm


def time_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def check_kernel(dev: torch.device) -> dict:
    from dealii_multigrid_tpu_torch.ops import tensor
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps
    from dealii_multigrid_tpu_torch.ops.hybrid_format import _assembled_1d

    rng = np.random.default_rng(0)
    p = 4
    measured = {}
    for dtype in (torch.float32, torch.float64):
        for S in (9, 17, 33):
            K = (S - 1) // p
            KS = torch.as_tensor(_assembled_1d(tensor.stiffness_matrix_1d(p), K, p), dtype=dtype, device=dev)
            MS = torch.as_tensor(_assembled_1d(tensor.mass_matrix_1d(p), K, p), dtype=dtype, device=dev)
            for NP in (1, 8, 512):
                xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
                sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
                got = ps.patch_stencil(xp, KS, MS, sc)
                ref = ps.patch_stencil_reference(xp, KS, MS, sc)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                rmax = float(ref.abs().max())
                if dtype == torch.float32:
                    ok = bool(torch.all((got - ref).abs() <= F32_ATOL_REL * rmax + F32_RTOL * ref.abs()))
                else:
                    ok = err <= F64_REL * rmax
                name = "f32" if dtype == torch.float32 else "f64"
                print(f"kernel check {name} S={S} NP={NP}: max_abs_err={err:.3e} "
                      f"max|ref|={rmax:.3e} ok={ok}", flush=True)
                check(ok, f"patch stencil kernel disagrees with the plain version ({name} S={S} NP={NP})")
                if dtype == torch.float32 and S == 33 and NP == 512:
                    measured["max_abs_err"] = err
                    # plain, kernel, kernel, plain: compare within one call
                    t_plain = [time_ms(lambda: ps.patch_stencil_reference(xp, KS, MS, sc), TIMED_LAUNCHES)]
                    t_kern = [time_ms(lambda: ps.patch_stencil(xp, KS, MS, sc), TIMED_LAUNCHES)]
                    t_kern.append(time_ms(lambda: ps.patch_stencil(xp, KS, MS, sc), TIMED_LAUNCHES))
                    t_plain.append(time_ms(lambda: ps.patch_stencil_reference(xp, KS, MS, sc), TIMED_LAUNCHES))
                    measured["ms"] = min(t_kern)
                    measured["plain_ms"] = min(t_plain)
                    print(f"stencil NP=512 S=33 f32: kernel {t_kern} ms, plain {t_plain} ms "
                          f"(each the mean of {TIMED_LAUNCHES} launches)", flush=True)
    return measured


def expected_launches(levels, result, prm) -> int:
    """Stencil launches the main path implies: each vmult of a level with
    patches launches once.  Eigenvalue estimation: eig_cg_n_iterations
    vmults per level above the coarsest; each CG iteration: one fine vmult
    plus one V-cycle of 2 * degree vmults per level above the coarsest
    (degree - 1 in the pre-smoother, 1 residual, degree in the
    post-smoother); the residual guard: one fine vmult; the RHS: one fine
    vmult only with a Dirichlet lift (none for "Constant")."""
    P = sum(1 for lv in levels[1:] if lv.op.NP > 0)
    fine = 1 if levels[-1].op.NP > 0 else 0
    deg = prm.mg_data.smoother.degree
    n = prm.mg_data.smoother.eig_cg_n_iterations * P
    n += sum(result.solve_iterations) * (fine + 2 * deg * P)
    return n + fine


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

    # 4a. small solve on the card against the same solve on the CPU
    small = bench_params(3, 2, "double", 1)
    res_gpu, _, _ = api.run(small, dev)
    res_cpu, _, _ = api.run(small, "cpu")
    rel = float((res_gpu.x.cpu() - res_cpu.x).abs().max() / res_cpu.x.abs().max())
    print(f"small solve r=3 p=2 double: card {res_gpu.n_iterations} it, cpu {res_cpu.n_iterations} it, "
          f"max rel diff {rel:.3e}", flush=True)
    check(res_gpu.n_iterations == res_cpu.n_iterations and rel <= 1e-8,
          "card solve disagrees with the CPU solve at r=3 p=2")

    # 4b. the main path: quadrant r=7 p=4, float, 5 repetitions
    prm = bench_params(7, 4, "float", 5)
    ps.launches.reset()
    t0 = time.perf_counter()
    result, _problem, levels = api.run(prm, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ps.launches.count
    expect = expected_launches(levels, result, prm)
    print(f"levels (NP, S, NS, use_cross): {[(lv.op.NP, lv.op.S, lv.op.NS, lv.op.use_cross) for lv in levels]}",
          flush=True)
    print(f"solve iterations {result.solve_iterations}; loop residual {result.residual_norm:.4e}, "
          f"true residual {result.true_residual:.4e} (allowance {result.guard_threshold:.4e}); "
          f"stencil launches {launches} (expected {expect})", flush=True)
    check(result.converged, "the r=7 solve did not converge")
    check(result.solve_iterations == [3] * (prm.mg_data.n_repetitions + 1),
          f"expected 3 CG iterations in every solve, got {result.solve_iterations}")
    check(result.true_residual <= result.guard_threshold, "true-residual guard failed")
    check(launches > 0 and launches == expect, f"stencil launches {launches} != expected {expect}")
    check("jax" not in sys.modules, "the port imported jax")
    x = result.x
    check(x.shape == (result.n_dofs,) and bool(torch.isfinite(x).all()),
          "the solution is not a finite vector of n_dofs values")
    print(f"HMG-global quadrant r=7 p=4 float: n_dofs {result.n_dofs}, iterations {result.n_iterations}, "
          f"solve {result.time:.6f} s (reps {[round(t, 6) for t in result.time_per_rep]}), "
          f"{result.throughput / 1e6:.3f} MDoF/s, setup {result.setup_time:.1f} s, "
          f"run wall {wall:.1f} s, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"card {card}", flush=True)

    # 5. result lines
    print(json.dumps({"kernels": [{
        "name": "patch_stencil",
        "route": "cuda",
        "source": "dealii_multigrid_tpu_torch/csrc/patch_stencil.cu",
        "replaces": "dealii_multigrid_tpu/ops/pallas_stencil.py:71",
        "launches": launches,
        "max_abs_err": measured["max_abs_err"],
        "ms": measured["ms"],
        "plain_ms": measured["plain_ms"],
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
