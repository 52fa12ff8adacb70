"""The patch-stencil kernel of this checkout against other checkouts' kernels,
on one card.

    python -m dealii_multigrid_tpu_torch.tools.compare_stencil PARENT_DIR \
        [OTHER_DIR ...] [--launches N] [--out FILE]

Each directory is a checkout of the port (for example the parent commit,
``git archive`` unpacked into a git-ignored directory); its
``dealii_multigrid_tpu_torch/csrc/patch_stencil.cu`` is built with nvcc and
the ``NVCC_FLAGS`` of its own ``ops/kernels.py``, beside this
checkout's, all builds started together.  At each shape of
``SHAPES`` (the main path's six levels and the p=1 levels of halved patch
size), in bfloat16, float32 and float64, on one set of inputs:

- every other library's output is compared with this checkout's, bit for
  bit;
- this checkout's bfloat16 output is compared, bit for bit, with its
  float32 output on the same values widened to float32 and rounded once to
  bfloat16 (the bf16 instance does the f32 instance's arithmetic);
- the libraries are timed in turns (PARENT, this, this, PARENT; with more
  directories A, B, this, this, B, A), each turn the mean of ``N``
  back-to-back launches queued behind a sleep kernel, between CUDA events.

Every line names the card (nvidia-smi name and power limit); ``--out``
writes every number as one JSON object.  Exits 1 where an output differs,
2 without a card.
"""

from __future__ import annotations

import argparse
import ast
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from dealii_multigrid_tpu_torch.ops import kernels, tensor
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps
from dealii_multigrid_tpu_torch.ops.hybrid_format import _assembled_1d

#: (NP, S, band): quadrant r=7 p=4's patch levels L7..L2, then the p=1
#: levels of halved patch size (S = 3 and 5, band 1)
SHAPES = ((512, 33, 4), (64, 33, 4), (8, 33, 4), (8, 17, 4), (27, 9, 4), (8, 9, 4),
          (512, 3, 1), (512, 5, 1))
MAIN = SHAPES[:6]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
ENTRY = {"bf16": "patch_stencil_bf16", "f32": "patch_stencil_f32", "f64": "patch_stencil_f64"}


def checkout_flags(root: str) -> tuple:
    """``NVCC_FLAGS`` of a checkout: its ``ops/kernels.py``, or in an older
    checkout without one its ``ops/patch_stencil.py``."""
    ops = os.path.join(root, "dealii_multigrid_tpu_torch", "ops")
    path = next(p for p in (os.path.join(ops, n) for n in ("kernels.py", "patch_stencil.py"))
                if os.path.exists(p))
    with open(path) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "NVCC_FLAGS" for t in node.targets):
                return tuple(ast.literal_eval(node.value))
    raise ValueError(f"{path} sets no NVCC_FLAGS")


def registers(build_log: str) -> dict:
    """Registers per thread of each kernel instance, from nvcc's ptxas -v
    lines: {"f32 B=4 R=3": 161, ...}."""
    out, name = {}, None
    kinds = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '.*fused_stencilI(f|d|13__nv_bfloat16)Li(\d)ELi(\d)E",
                      line)
        if m:
            name = f"{kinds[m.group(1)]} B={m.group(2)} R={m.group(3)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name], name = int(m.group(1)), None
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def inputs(NP: int, S: int, band: int, dtype, rng) -> tuple:
    """Random u and pscale, and the assembled degree-``band`` KS and MS."""
    K = (S - 1) // band
    KS, MS = (torch.as_tensor(_assembled_1d(m(band), K, band), dtype=dtype, device="cuda")
              for m in (tensor.stiffness_matrix_1d, tensor.mass_matrix_1d))
    xp = torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=dtype, device="cuda")
    sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=dtype, device="cuda")
    return xp, KS, MS, sc


def launcher(lib: ctypes.CDLL, tag: str, xp, KS, MS, sc, band: int):
    """A call of the library's entry for ``tag`` into a fresh output; the
    call returns that output."""
    fn = getattr(lib, ENTRY[tag])
    out = torch.empty_like(xp)
    stream = torch.cuda.current_stream().cuda_stream
    args = (xp.data_ptr(), KS.data_ptr(), MS.data_ptr(), sc.data_ptr(), out.data_ptr(),
            xp.shape[0], KS.shape[0], band, 0, stream)

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"{tag} launch failed: {lib.patch_stencil_error_string(err).decode()}")
        return out

    return call


def time_ms(fn, n: int) -> float:
    """Device time per call: n calls queued behind a sleep kernel, between
    CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+", help="checkouts to compare with this one, parent first")
    ap.add_argument("--launches", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_stencil: no CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    names = [os.path.normpath(d) for d in args.dirs] + ["this"]
    sources = [os.path.join(d, "dealii_multigrid_tpu_torch", "csrc", "patch_stencil.cu")
               for d in args.dirs] + [ps.SOURCE]
    libraries = [kernels.Library("patch_stencil", ps.bind, src, checkout_flags(d))
                 for src, d in zip(sources, args.dirs)]
    libraries.append(ps.library)
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        list(pool.map(lambda lib: lib.build(), libraries))
    libs = [lib.for_device(0) for lib in libraries]
    for name, lib in zip(names, libraries):
        print(f"compare_stencil: {name}: {lib.path}, built in {lib.build_seconds:.1f} s, "
              f"registers per instance {registers(lib.build_log)}; card {card}", flush=True)
    for lib in libs:
        for tag in ENTRY.values():
            fn = getattr(lib, tag)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    rng = np.random.default_rng(11)
    rows, all_equal = [], True
    for tag, dtype in DTYPES.items():
        for NP, S, band in SHAPES:
            xp, KS, MS, sc = inputs(NP, S, band, dtype, rng)
            calls = [launcher(lib, tag, xp, KS, MS, sc, band) for lib in libs]
            mine = calls[-1]().clone()
            equal = {names[i]: bool(torch.equal(calls[i](), mine)) for i in range(len(libs) - 1)}
            row = {"dtype": tag, "NP": NP, "S": S, "band": band, "bit_equal": equal}
            if tag == "bf16":
                wide = launcher(libs[-1], "f32", *(t.float() for t in (xp, KS, MS, sc)), band)
                row["bit_equal_f32_rounded_once"] = bool(torch.equal(wide().to(dtype), mine))
                equal = {**equal, "f32 rounded once": row["bit_equal_f32_rounded_once"]}
            times = {name: [] for name in names}
            for i in order:
                times[names[i]].append(time_ms(calls[i], args.launches))
            row["ms"] = times
            rows.append(row)
            all_equal &= all(equal.values())
            print(f"{tag} NP={NP} S={S} band={band}: " + "; ".join(
                f"{name} {np.mean(t):.6f} ms {[round(x, 6) for x in t]}" for name, t in times.items())
                + f"; bit-equal to this: {equal}; card {card}", flush=True)
    sums = {tag: {name: sum(float(np.mean(r["ms"][name])) for r in rows
                            if r["dtype"] == tag and (r["NP"], r["S"], r["band"]) in MAIN)
                  for name in names} for tag in DTYPES}
    for tag, by_name in sums.items():
        print(f"{tag} sum over the six main-path shapes: "
              + "; ".join(f"{name} {v:.6f} ms" for name, v in by_name.items()) + f"; card {card}",
              flush=True)
    for NP, S, band in SHAPES:
        bf, f32 = (float(np.mean(r["ms"]["this"])) for r in rows
                   if (r["NP"], r["S"]) == (NP, S) and r["dtype"] in ("bf16", "f32"))
        print(f"this checkout NP={NP} S={S}: bf16 / f32 {bf / f32:.4f}; card {card}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "libraries": dict(zip(names, sources)), "rows": rows,
                       "sums_main_ms": sums}, f, indent=1)
    print(json.dumps({"all_bit_equal": all_equal, "card": card}))
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
