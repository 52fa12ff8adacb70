"""Probe: do the MG phase timers of the PyTorch port add up to a V-cycle?

    python scripts/probe_phases.py [--types HMG-global PMG] [--n-ref 7]

On one CUDA card, for each solver type at quadrant p=4 (float levels; PMG
in NumberType mixed with the AMG coarse solve): solves through ``api.run``,
then times with the phase timers' own clock (``utils.phases._loop_time``)
  * one whole V-cycle (``PreconditionMG.vmult``) and one fine vmult, the
    V-cycle also on the host clock as the solve is timed,
  * the phases, each applied at all its levels (``profile_preconditioner``),
  * the phases level by level (``profile_preconditioner_per_level``),
each at 8 and at 32 applications per measurement, and prints them beside
the solve's time per CG iteration.  Every line names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dealii_multigrid_tpu_torch import api  # noqa: E402
from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG  # noqa: E402
from dealii_multigrid_tpu_torch.utils import phases  # noqa: E402
from dealii_multigrid_tpu_torch.utils.device import describe_device  # noqa: E402
from dealii_multigrid_tpu_torch.utils.params import RunParameters  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--types", nargs="+", default=["HMG-global", "PMG"])
    ap.add_argument("--n-ref", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_phases: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = describe_device(dev)
    for mg_type in args.types:
        prm = RunParameters()
        prm.type = mg_type
        prm.geometry_type = "quadrant"
        prm.n_ref_global = args.n_ref
        prm.fe_degree_fine = 4
        prm.number_type = "mixed" if mg_type == "PMG" else "float"
        prm.mg_number_type = "float"
        prm.mg_data.smoother.degree = 3
        prm.mg_data.n_repetitions = 5
        res, _, levels = api.run(prm, dev)
        outer = api.number_dtype(prm.number_type)
        precond = PreconditionMG(res.mg, outer)
        b = res.rhs_used
        fine = levels[-1].op
        b_level = b.to(fine.dtype)
        per_it = res.time / res.n_iterations
        print(f"{mg_type} r={args.n_ref} p=4: {res.n_iterations} iterations, solve {res.time:.6f} s "
              f"(reps {[round(t, 6) for t in res.time_per_rep]}), {per_it * 1e3:.3f} ms per iteration; "
              f"{card}", flush=True)
        # the V-cycle on the solve's own clock: n_iterations applications,
        # a synchronise, the best of 5
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(res.n_iterations):
                precond.vmult(b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / res.n_iterations)
        print(f"{mg_type}: V-cycle on the host clock, {res.n_iterations} in a row, best of 5: "
              f"{min(walls) * 1e3:.3f} ms each (all {[round(w * 1e3, 3) for w in walls]}); {card}",
              flush=True)
        for n_loop in (8, 32):
            t_v = phases._loop_time(lambda: precond.vmult(b), dev, n_loop)
            t_a = phases._loop_time(lambda: fine.vmult(b_level), dev, n_loop)
            summed = phases.profile_preconditioner(precond, b, n_loop)
            per_level = phases.profile_preconditioner_per_level(precond, b, n_loop)
            by_level = {ph: sum(v) for ph, v in per_level.items()}
            print(f"{mg_type} n_loop={n_loop}: whole V-cycle {t_v * 1e3:.3f} ms, fine vmult "
                  f"{t_a * 1e3:.3f} ms; phases at all levels sum {sum(summed.values()) * 1e3:.3f} ms "
                  f"{ {k: round(v * 1e3, 3) for k, v in summed.items()} }; level by level sum "
                  f"{sum(by_level.values()) * 1e3:.3f} ms "
                  f"{ {k: round(v * 1e3, 3) for k, v in by_level.items()} }; {card}", flush=True)
        del res, levels, precond, b, b_level, fine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
