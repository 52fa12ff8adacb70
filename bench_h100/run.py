"""The port's H100 benchmark, one run of one cell.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this folder and the
``dealii_multigrid_tpu_torch`` package.  The run builds the cell's
hierarchy through the port's own set-up functions, runs one warm-up solve,
then solves back to back for ``--seconds`` (one solve in flight, each on
its own right-hand side from the seed), and checks sampled solves of the
window against the plain reference in ``reference/``.  The last line of
standard output is the result (JSON); the numbers the check compared, each
beside its limit, are the last lines of standard error.  With ``--trace 1``
the solves run through the port's phase recorder and a profiler window
follows, and the result carries the per-layer metrics.

It exits 2 without a result when no CUDA card is there (or fewer than the
cell asks for), and 4 when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's build and kernel caches: fixed directories inside the
# checkout, so that only a checkout's first run builds
CACHE = os.path.join(ROOT, ".bench_h100_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from harness import bench

    t_start = bench.process_start(T_IMPORT)
    cell = bench.Cell.find(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    result = bench.measure(
        cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"), t_start,
        log=lambda s: print(s, file=sys.stderr, flush=True),
    )
    found = bench.forbidden_modules()
    if found:
        print(f"[bench] the process loaded {found}: no result", file=sys.stderr)
        return 4
    for name, v in result["limits"].items():
        print(f"[bench] {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
