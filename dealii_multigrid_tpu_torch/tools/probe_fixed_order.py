"""Time the hybrid engine's vmult and restriction at the main path's finest
level, and count bit-equal float32 repeats, for one checkout of the port.

    python dealii_multigrid_tpu_torch/tools/probe_fixed_order.py \
        [--root DIR] [--label NAME] [--calls N] [--solve]

``--root`` is the directory holding the ``dealii_multigrid_tpu_torch``
package to measure (default: the checkout holding this file).  Run the
file by its path, not with ``-m``, so that the package comes from
``--root``.  To compare two commits on one card, unpack the other with
``git archive`` into a git-ignored directory and run both from one
command, in the order parent, change, change, parent.
On quadrant r=7 p=4 float (the main path), it builds the finest level L7
and L6 on the card, then for ``HybridOperator.vmult`` and the L7 -> L6
``HybridTransfer.restrict``: the mean time of ``--calls`` back-to-back
calls between two CUDA events, once queued behind a sleep kernel (device
time) and once from an idle card (what a solve pays, host dispatch
included), and how many of 20 applications to one float32 input equal the
first bit for bit.  With ``--solve`` it also runs the main path's solve
through ``api.run`` (5 timed repetitions after a warm-up) and reports the
best and every repetition.  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    here = os.path.abspath(__file__)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(here))))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--solve", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    from dealii_multigrid_tpu_torch import api
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence
    from dealii_multigrid_tpu_torch.ops import patch_stencil as ps
    from dealii_multigrid_tpu_torch.ops.hybrid_transfer import make_hybrid_transfer
    from dealii_multigrid_tpu_torch.utils.params import RunParameters

    assert api.__file__.startswith(root), f"imported {api.__file__}, not from {root}"
    if not torch.cuda.is_available():
        print("probe_fixed_order: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    ps.build()
    seq = geometric_coarsening_sequence(generators.create("quadrant", 3, 7, 0))
    coarse, fine = (api.build_level_hybrid(m, 4, dev, torch.float32) for m in seq[-2:])
    tr = make_hybrid_transfer(fine.fmt, coarse.fmt, fine.op, coarse.op)
    x = torch.as_tensor(
        fine.fmt.from_global(np.random.default_rng(20).standard_normal(fine.dofh.n_dofs)),
        dtype=torch.float32, device=dev,
    )

    def timed(fn, behind_sleep: bool) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if behind_sleep:
            torch.cuda._sleep(200_000_000)  # longer than enqueuing the calls
        start.record()
        for _ in range(args.calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.calls

    def repeats(fn) -> int:
        ref = fn(x)
        return 1 + sum(int(torch.equal(fn(x), ref)) for _ in range(19))

    out = {"label": args.label, "card": card, "n_slots_L7": fine.fmt.n_slots}
    for name, fn in (("vmult", fine.op.vmult), ("restrict", tr.restrict)):
        out[name] = {
            "device_ms": min(timed(lambda: fn(x), True) for _ in range(2)),
            "idle_card_ms": min(timed(lambda: fn(x), False) for _ in range(2)),
            "bit_equal_of_20": repeats(fn),
        }
    if args.solve:
        del coarse, fine, tr, x
        torch.cuda.empty_cache()
        prm = RunParameters()
        prm.type, prm.geometry_type, prm.n_ref_global, prm.fe_degree_fine = "HMG-global", "quadrant", 7, 4
        prm.number_type = prm.mg_number_type = "float"
        prm.mg_data.coarse_solver.type = "amg"
        prm.mg_data.smoother.degree = 3
        prm.mg_data.cg_normal.reltol = 1e-4
        prm.mg_data.n_repetitions = 5
        res, _, _ = api.run(prm, dev)
        out["solve"] = {"best_s": res.time, "reps_s": res.time_per_rep,
                        "iterations": res.solve_iterations}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
