"""The readings the check's limits are set from, at a cell's own size.

    python3 bench_h100/tools/readings.py --workload <cell> --seeds 12 \
        [--variant sound|control_bf16|control_float|fault_identity|fault_scaled] ...

For each variant the cell's hierarchy is built once (the configuration,
or for a control the configuration with a lower precision switched on in
the program: bfloat16 levels, or a float32 outer CG), then for each seed
the solves that seed's run would check are solved with that seed's loads,
and the reference reads ``true_residual``, ``residual_gap`` and ``first_step_residual`` from
them as a run does.  Faults break the timed path on the sound hierarchy:
``fault_identity`` hands back the preconditioner's input (a V-cycle that
leaves its state unchanged), ``fault_scaled`` alters each answer where it
is produced (x times 1 + 1e-3).  One JSON line per variant and seed; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

VARIANTS = {
    "sound": {},
    "control_bf16": {"MGNumberType": "bfloat16"},
    "control_float": {"NumberType": "float"},
    "fault_identity": {},
    "fault_scaled": {},
}


class _Identity:
    def vmult(self, b):
        return b


def samples_for(cell, overrides: dict, seeds: list, device, variant: str) -> dict:
    """{seed: [Sample]} of one variant's hierarchy."""
    import torch

    from harness import check as chk
    from harness.system import FirstApply, System
    from harness.traffic import Loads

    solver = dict(cell.config["solver"], **overrides)
    cell = dataclasses.replace(cell, config=dict(cell.config, solver=solver))
    system = System(cell.params(), device)
    pre = FirstApply(_Identity()) if variant == "fault_identity" else system.wrapper
    out = {}
    for seed in seeds:
        loads = Loads(cell.traffic, seed)
        got = []
        for k in loads.checked:
            a, b = loads.pair(k)
            pre.armed = True
            res = system.solve(system.rhs(a, b), pre)
            x = res.x * (1.0 + 1e-3) if variant == "fault_scaled" else res.x
            got.append(chk.Sample(k, a, b, system.to_host(x), system.to_host(pre.first),
                                  res.residual_norm / res.norm0, k == loads.steady))
            got[-1].iterations = res.n_iterations
        out[seed] = got
    del system, pre
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch

    from harness import bench
    from harness import check as chk

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--variant", action="append", choices=sorted(VARIANTS))
    ap.add_argument("--n-ref", type=int, help="a smaller mesh (CPU rehearsal)")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cell = bench.Cell.find(args.workload)
    if args.n_ref is not None:
        cell.traffic["mesh"] = dict(cell.traffic["mesh"], NRefGlobal=args.n_ref)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    variants = args.variant or ["sound"]
    points, found = None, {}
    for v in variants:
        t0 = time.perf_counter()
        # the controls and faults need three seeds
        found[v] = samples_for(cell, VARIANTS[v], seeds if v == "sound" else seeds[:3], device, v)
        print(f"[readings] {v}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    params = cell.params()
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.mesh.dof import distribute_dofs

    mesh = generators.create(params.geometry_type, 3, params.n_ref_global, params.n_ref_local)
    points = distribute_dofs(mesh, params.fe_degree_fine).points
    t0 = time.perf_counter()
    referee = chk.Referee(cell.config["reference"], cell.traffic["mesh"], params.fe_degree_fine, device)
    print(f"[readings] reference built in {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    for v, per_seed in found.items():
        for seed, samples in per_seed.items():
            r = referee.read(points, samples)
            print(json.dumps({"workload": args.workload, "variant": v, "seed": seed,
                              "iterations": [s.iterations for s in samples], **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
