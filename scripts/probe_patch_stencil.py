"""Probe the patch-stencil CUDA kernel on one card (PyTorch port).

    python scripts/probe_patch_stencil.py [--sass] [--ablate] [--variants] [--clock]
                                          [--parent DIR]

Builds dealii_multigrid_tpu_torch/csrc/patch_stencil.cu, then
  * with --sass: prints the SASS opcode histogram of the float and double
    band-4 instances (cuobjdump from the CUDA toolkit);
  * with --ablate: builds copies of the source with one part of the kernel
    cut out (results wrong on purpose: for timing only) and times each at
    NP = 512, S = 33, band 4, float32 and float64, beside the full kernel;
  * with --variants: the same for design variants, at the six main-path
    shapes (results checked against the plain version);
  * with --clock: per-warp clock64 cycle counts of block 0 in each phase of
    the plane loop (a copy of the source with counters added);
  * with --parent DIR: times the kernel of another checkout at DIR (for
    example the parent commit, unpacked with git archive) against this
    one at the six main-path shapes in float32 and at (512, 33) in
    float64, in turns (parent, change, change, parent), and compares their
    results;
  * times the kernel at NP = 512, S = 33 with random KS, MS zero outside
    band b, for b = 1..8, in float32 and float64 (CUDA events, launches
    queued behind a sleep kernel, mean of 30), beside each shape's bound;
  * times the six main-path shapes in float32.
Every line names the card (nvidia-smi name and power limit).  Needs a card.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import MAIN_SHAPES, assembled, bound, card_line, time_ms  # noqa: E402
from dealii_multigrid_tpu_torch.ops import kernels  # noqa: E402
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps  # noqa: E402


def sass_histogram(path: str, pattern: str) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    hist: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)(\.[A-Z0-9_.]+)?", line)
        if name and re.search(pattern, name) and m:
            key = name
            hist.setdefault(key, collections.Counter())[m.group(1)] += 1
    return hist


#: the main plane loop of the kernel
PLANE_LOOP = "#pragma unroll 3\n  for (int n = 0; n < nplanes; ++n) {"


#: kernel parts cut out by --ablate: (source text, replacement)
ABLATIONS = {
    "no_load": ("for (int r = cy; r < nzr; r += nch) cp_async", "for (int r = cy; r < 0; r += nch) cp_async"),
    # the fused z contraction of the next plane
    "no_z": ("yz_columns<T, B, R, kYRegs, true>", "yz_columns<T, B, R, kYRegs, false>"),
    # the y and the fused z contraction (one loop)
    "no_yz": ("for (int j = 0; j < R + 2 * B; ++j) {", "for (int j = 0; j < 0; ++j) {"),
    # the x scatter into the ring (the ring still shifts and stores)
    "no_x": ("x_step<T, B, R, true>(acc, C, D", "x_step<T, B, R, false>(acc, C, D"),
    "no_store": ("if (i < nvalid) dst[i * S]", "if (i < nvalid && scale == T(-12345)) dst[i * S]"),
    "no_barrier": ("    __syncthreads();  // AM/AK of plane n", "    //"),
}


#: design variants for --variants: name -> [(source text, replacement), ...]
VARIANTS = {
    # y/z coefficients from shared memory, 4 stages, two blocks per SM
    "smem_coef_occ2": [
        ("constexpr bool kYRegs = sizeof(T) * R * W <= 108;", "constexpr bool kYRegs = false;"),
        ("__launch_bounds__(kMaxThreads, 1)",
         "__launch_bounds__(kMaxThreads, sizeof(T) == 4 && B <= 4 ? 2 : 1)"),
        ("static constexpr int kStages = 8;", "static constexpr int kStages = 4;"),
    ],
    "stages4": [("static constexpr int kStages = 8;", "static constexpr int kStages = 4;")],
    # the x step of a plane after the next plane's y contraction, in program
    # order, so that its FMAs could cover the latency of that plane's loads
    "x_after_next_y": [
        ("  // unrolled, the ring", "  T Cp[R] = {}, Dp[R] = {};\n  // unrolled, the ring"),
        ("    const int x = xi0 + n, o = x - B;\n", "    const int x = xi0 + n - 1, o = x - B;\n"),
        ("    x_step<T, B, R, true>(acc, C, D, xc + x * W, store,\n"
         "                          store ? obase + static_cast<size_t>(o) * SS : nullptr, S, nvalid, scale);\n  }\n",
         "    x_step<T, B, R, true>(acc, Cp, Dp, xc + max(x, 0) * W, store,\n"
         "                          store ? obase + static_cast<size_t>(o) * SS : nullptr, S, nvalid, scale);\n"
         "    for (int i = 0; i < R; ++i) Cp[i] = C[i], Dp[i] = D[i];\n  }\n"
         "  {\n    const int x = xi1 - 1, o = x - B;\n    const bool store = o >= x0 && o < x1;\n"
         "    x_step<T, B, R, true>(acc, Cp, Dp, xc + x * W, store,\n"
         "                          store ? obase + static_cast<size_t>(o) * SS : nullptr, S, nvalid, scale);\n  }\n"),
    ],
    # the plane loop not unrolled (the ring shifts by 27 moves a plane), or
    # unrolled 9 times (= 2 band + 1 at band 4: no moves)
    "unroll1": [(PLANE_LOOP, PLANE_LOOP.replace("unroll 3", "unroll 1"))],
    "unroll9": [(PLANE_LOOP, PLANE_LOOP.replace("unroll 3", "unroll 9"))],
    # two rows per thread: 17 chunks x 33 columns = 561 threads at S = 33
    "kr2": [
        ("constexpr int kRowsLarge = 3;", "constexpr int kRowsLarge = 2;"),
        ("constexpr int kMaxThreads = 384;", "constexpr int kMaxThreads = 576;"),
    ],
    # four rows per thread: 9 chunks x 33 columns = 297 threads at S = 33
    "kr4": [("constexpr int kRowsLarge = 3;", "constexpr int kRowsLarge = 4;")],
    # three rows per thread at every S (one warp of 27 threads at S = 9)
    "rows3_small_s": [("return S * S <= kMaxThreads\n", "return S * S <= 0\n")],
}


#: --clock: per-warp cycle counters (clock64) around the phases of the plane
#: loop, written by block 0 over the start of out as [warp][wait, prefetch,
#: y/z, x step, whole kernel]
CLOCK = [
    ("  const bool fused = geo.nty == 1;\n",
     "  const bool fused = geo.nty == 1;\n  long long t_wait = 0, t_pre = 0, t_yz = 0, t_x = 0, "
     "t_all = clock64(), t0, t1;\n"),
    ("    cp_async_wait<kStages - 3>();\n",
     "    t0 = clock64();\n    cp_async_wait<kStages - 3>();\n"),
    ("    __syncthreads();  // AM/AK of plane n and u of plane n + 1 are visible\n",
     "    __syncthreads();  // AM/AK of plane n and u of plane n + 1 are visible\n"
     "    t1 = clock64(); t_wait += t1 - t0; t0 = t1;\n"),
    ("    cp_async_commit();\n    const int bn",
     "    cp_async_commit();\n    t1 = clock64(); t_pre += t1 - t0; t0 = t1;\n"
     "    const int bn"),
    ("    const int x = xi0 + n, o = x - B;\n",
     "    t1 = clock64(); t_yz += t1 - t0; t0 = t1;\n    const int x = xi0 + n, o = x - B;\n"),
    ("S, nvalid, scale);\n  }\n  // planes past",
     "S, nvalid, scale);\n    t_x += clock64() - t0;\n  }\n  // planes past"),
    ("                        store ? obase + static_cast<size_t>(o) * SS : nullptr, S, nvalid, scale);\n  }\n}\n",
     "                        store ? obase + static_cast<size_t>(o) * SS : nullptr, S, nvalid, scale);\n  }\n"
     "  t_all = clock64() - t_all;\n"
     "  if (blockIdx.x == 0 && threadIdx.x % 32 == 0) {\n    T* o5 = out + threadIdx.x / 32 * 5;\n"
     "    o5[0] = T(t_wait); o5[1] = T(t_pre); o5[2] = T(t_yz); o5[3] = T(t_x); o5[4] = T(t_all);\n  }\n}\n"),
]


def clock_probe(dev, card: str) -> None:
    lib = build_variants({"clock": CLOCK})["clock"]
    rng = np.random.default_rng(2)
    NP, S = 512, 33
    for dtype in (torch.float32, torch.float64):
        KS, MS = assembled(4, S, dtype, dev)
        xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
        sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
        out = torch.empty_like(xp)
        fn = lib.patch_stencil_f32 if dtype == torch.float32 else lib.patch_stencil_f64
        for _ in range(3):
            fn(xp.data_ptr(), KS.data_ptr(), MS.data_ptr(), sc.data_ptr(), out.data_ptr(),
               NP, S, 4, 0, torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        warps = (S * ((S + 2) // 3) + 31) // 32
        cyc = out[0, : 5 * warps].view(warps, 5).double().cpu()
        for w in range(warps):
            c = [int(v) for v in cyc[w]]
            print(f"clock {str(dtype)[6:]} NP={NP} S={S} block 0 warp {w}: wait+barrier {c[0]}, "
                  f"prefetch {c[1]}, y/z {c[2]}, x step {c[3]}, kernel {c[4]} cycles; card {card}",
                  flush=True)


def build_variants(edits: dict) -> dict:
    """Compile edited copies of the kernel source in parallel -> {name: CDLL}."""
    import ctypes

    src = open(ps.SOURCE).read()
    out_dir = os.path.join(kernels.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"variant {name}: source text not found: {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [ps.library.nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{err}")
        lib = ctypes.CDLL(so)
        for fn in (lib.patch_stencil_f32, lib.patch_stencil_f64):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.patch_stencil_init.argtypes = [ctypes.c_int]
        if lib.patch_stencil_init(0) != 0:
            raise RuntimeError(f"variant {name}: init failed")
        libs[name] = lib
    return libs


def ablate(dev, card: str, edits: dict, check_result: bool, shapes=((512, 33),)) -> None:
    libs = build_variants(edits)
    rng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.float64):
        for NP, S in shapes:
            KS, MS = assembled(4, S, dtype, dev)
            xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
            sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
            out = torch.empty_like(xp)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def call(lib):
                fn = lib.patch_stencil_f32 if dtype == torch.float32 else lib.patch_stencil_f64
                err = fn(xp.data_ptr(), KS.data_ptr(), MS.data_ptr(), sc.data_ptr(),
                         out.data_ptr(), NP, S, 4, 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            full = time_ms(lambda: ps.patch_stencil(xp, KS, MS, sc, 4), 30)
            ref = ps.patch_stencil_reference(xp, KS, MS, sc)
            for name, lib in libs.items():
                ms = time_ms(lambda: call(lib), 30)
                note = ""
                if check_result:
                    call(lib)
                    err = float((out - ref).abs().max() / ref.abs().max())
                    note = f", max rel err {err:.3e}"
                print(f"{'variant' if check_result else 'ablation'} {str(dtype)[6:]} NP={NP} "
                      f"S={S} band=4 {name}: {ms:.6f} ms (full kernel {full:.6f} ms{note}); "
                      f"card {card}", flush=True)


def load_parent(root: str):
    """The patch-stencil wrapper of the checkout at ``root``, as a module of
    its own (it builds its kernel into its own _build/)."""
    import importlib.util

    path = os.path.join(root, "dealii_multigrid_tpu_torch", "ops", "patch_stencil.py")
    spec = importlib.util.spec_from_file_location("parent_patch_stencil", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_parent(dev, card: str, root: str) -> None:
    par = load_parent(root)
    par.build()
    rng = np.random.default_rng(3)
    for dtype, shapes in ((torch.float32, MAIN_SHAPES), (torch.float64, MAIN_SHAPES[:1])):
        for NP, S in shapes:
            KS, MS = assembled(4, S, dtype, dev)
            xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
            sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
            new = lambda: ps.patch_stencil(xp, KS, MS, sc, 4)  # noqa: E731
            old = lambda: par.patch_stencil(xp, KS, MS, sc)  # noqa: E731
            t = [time_ms(old, 30), time_ms(new, 30), time_ms(new, 30), time_ms(old, 30)]
            a, b = old(), new()
            diff = float((a - b).abs().max() / a.abs().max())
            print(f"parent vs change {str(dtype)[6:]} NP={NP} S={S}: parent {t[0]:.6f}, "
                  f"{t[3]:.6f} ms; change {t[1]:.6f}, {t[2]:.6f} ms; speed-up "
                  f"{min(t[0], t[3]) / min(t[1], t[2]):.2f}x; max rel diff {diff:.3e}; "
                  f"card {card}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    ps.library.build()
    print(f"library {ps.library.path}; card {card}", flush=True)
    if "--sass" in sys.argv:
        for name, hist in sass_histogram(ps.library.path, r"fused_stencilI[fd]Li4E").items():
            total = sum(hist.values())
            top = ", ".join(f"{k} {v}" for k, v in hist.most_common(24))
            print(f"SASS {name}: {total} instructions: {top}", flush=True)
    if "--ablate" in sys.argv:
        ablate(dev, card, {k: [v] for k, v in ABLATIONS.items()}, check_result=False)
    if "--clock" in sys.argv:
        clock_probe(dev, card)
    if "--variants" in sys.argv:
        ablate(dev, card, VARIANTS, check_result=True, shapes=MAIN_SHAPES)
    if "--parent" in sys.argv:
        compare_parent(dev, card, sys.argv[sys.argv.index("--parent") + 1])
    rng = np.random.default_rng(0)
    NP, S = 512, 33
    i, j = np.indices((S, S))
    for dtype in (torch.float32, torch.float64):
        xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device=dev)
        sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device=dev)
        for b in ps.BANDS:
            KS, MS = (torch.as_tensor(np.where(abs(i - j) <= b, rng.standard_normal((S, S)), 0.0),
                                      dtype=dtype, device=dev) for _ in range(2))
            ms = time_ms(lambda: ps.patch_stencil(xp, KS, MS, sc, b), 30)
            b_ms, b_by = bound(NP, S, KS, MS, dtype)
            print(f"band sweep {str(dtype)[6:]} NP={NP} S={S} band={b}: {ms:.6f} ms, bound "
                  f"{1e3 * b_ms:.2f} us ({b_by}), share {b_ms / ms:.4f}; card {card}", flush=True)
    for NP, S in MAIN_SHAPES:
        KS, MS = assembled(4, S, torch.float32, dev)
        xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=torch.float32, device=dev)
        sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=torch.float32, device=dev)
        ms = time_ms(lambda: ps.patch_stencil(xp, KS, MS, sc, 4), 30)
        b_ms, b_by = bound(NP, S, KS, MS, torch.float32)
        print(f"shape float32 NP={NP} S={S}: {ms:.6f} ms, bound {1e3 * b_ms:.2f} us ({b_by}), "
              f"share {b_ms / ms:.4f}; card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
