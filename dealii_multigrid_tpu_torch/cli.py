"""Benchmark command line.

    python -m dealii_multigrid_tpu_torch.cli input_0001.json [...] [--device cpu]

Mirror of the reference executable's main() (multigrid_throughput.cc:2398-2470):
parse each JSON parameter file, run it, append one row to a cumulative
ConvergenceTable printed after every run.  Without ``--device`` the runs go
to ``cuda:0`` and fail without a card.

Under ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` above 1) every process
joins one gloo group and runs each file as its rank of a sharded solve
(``NShards`` N, or 0 for the group's size); rank 0 prints.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys

import numpy as np
import torch

from . import api
from .mesh import generators
from .models import poisson
from .parallel import metrics
from .parallel.partition import partition_hierarchy
from .solvers.local_smoothing import level_mesh
from .utils.device import describe_device, resolve_device
from .utils.params import RunParameters
from .utils.phases import AMG_SHAPE, format_per_level_table
from .utils.table import ConvergenceTable
from .utils.vtu import write_vtu

_MG_TYPES = ("PMG", "HMG-global", "HPMG", "HMG-local", "HPMG-local")


def _print_amg_hierarchy() -> None:
    """Rows, widest rows (K) and table bytes per AMG level where the run
    built an AMG (``AMG_SHAPE``, emptied before the run)."""
    if not AMG_SHAPE:
        return
    n = AMG_SHAPE["dense_rows"]
    print(f"\nAMG hierarchy ({AMG_SHAPE['n_cycles']} cycle(s) per application; dense coarsest "
          f"factor {(n, n)}):")
    print("level rows K_A K_P K_PT bytes omega")
    for i, d in enumerate(AMG_SHAPE["levels"]):
        print(f"{i:<5} {d['rows']} {d['K_A']} {d['K_P']} {d['K_PT']} {d['bytes']} "
              f"{d['omega']:.4g}")


def run_config(params: RunParameters, table: ConvergenceTable, device: torch.device) -> None:
    mesh = generators.create(
        params.geometry_type, params.dim, params.n_ref_global, params.n_ref_local
    )
    table.new_row()
    table.add_value("dim", params.dim)
    table.add_value("type", params.type)
    table.add_value("geometry", params.geometry_type)
    table.add_value("n_cells", mesh.n_cells)
    table.add_value("degree", params.fe_degree_fine)
    table.add_value("n_ref_global", params.n_ref_global)
    table.add_value("n_ref_local", params.n_ref_local)
    # Swept-knob identity columns: the parameter-study families emit many
    # rows per mesh identity, which these columns tell apart (the reference
    # distinguishes such rows only by input-file order,
    # multigrid_throughput.cc:2420-2442).
    table.add_value("min_level", params.min_level)
    table.add_value("coarse_type", params.mg_data.coarse_solver.type)
    table.add_value("n_cycles", params.mg_data.coarse_solver.n_cycles)
    table.add_value("smoother_deg", params.mg_data.smoother.degree)
    table.add_value("reltol", params.mg_data.cg_normal.reltol)
    table.add_value("number", params.number_type)
    table.add_value("mg_number", params.mg_number_type)
    table.add_value("policy", params.effective_policy_name() or "Default")

    AMG_SHAPE.clear()
    result, problem, levels = api.dispatch_solve(params, mesh, device)

    # hanging-node cell census (reference: multigrid_throughput.cc:2177-2190)
    dofh = problem.dofh
    slave_set = np.zeros(dofh.n_dofs, bool)
    slave_set[problem.hanging.slave] = True
    n_hn = int(slave_set[dofh.cell_dofs].any(axis=1).sum())
    table.add_value("n_cells_hn", n_hn)
    table.add_value("n_cells_n", mesh.n_cells - n_hn)

    table.add_value("n_dofs", result.n_dofs)
    table.add_value("n_levels", result.n_levels)
    # the sub-communicator analog: ranks of the coarsest level
    table.add_value("sub_comm_size", result.sub_comm_size)
    table.add_value("n_iterations", result.n_iterations)
    table.add_value("converged", result.converged)
    table.add_value("time", result.time)

    # time_per_it is the best timed solve per iteration.  With ProfilePhases
    # the MG phase columns (reference multigrid_throughput.cc:1381-1401) and
    # time_cg come from the one instrumented solve after the timed ones: its
    # phases per iteration, and its iteration time minus their sum
    # (:1270-1283), >= 0 because the phases are timed inside it
    phases = result.phases
    table.add_value("time_per_it", result.time / max(result.n_iterations, 1))
    if phases is not None:
        table.add_value("time_cg", result.phase_iteration_time - sum(phases.values()))
    table.add_value("throughput", result.throughput)
    if phases is not None:
        for ph in ("pre", "residuum", "res", "cs", "pro", "edge_pro", "post"):
            table.add_value(f"time_{ph}", phases[ph])
        table.add_value("time_to_mg", phases["to_mg"])
        table.add_value("time_to_global", phases["to_global"])
        if params.verbose:
            # reference-shaped per-level phase matrix
            # (multigrid_throughput.cc:1285-1379), from the same solve
            print("\nMG phases per level (s, one V-cycle):")
            print(format_per_level_table(result.phases_per_level))

    if params.verbose:
        _print_amg_hierarchy()

    if params.paraview:
        write_vtu("solution.vtu", problem.dofh, problem.full_solution(result.x))

    if params.verbose and params.type in _MG_TYPES:
        if params.type in ("HMG-local", "HPMG-local"):
            # the reference prints MG statistics for local smoothing from the
            # single-tria LEVEL hierarchy (multigrid_throughput.cc:1866,
            # mg_tools.h:267 overload): level l = all tree cells at level l
            meshes = [
                level_mesh(mesh, l)
                for l in range(max(params.min_level, 0), mesh.max_level + 1)
            ]
        else:
            meshes = [lv.mesh for lv in levels]
        # the ranks and partitions of the run (an unsharded run has 1 shard)
        n_shards = result.n_shards
        partitions = result.partitions
        if partitions is not None:
            # the partitions actually applied: a replicated level owns
            # everything on rank 0 (the sub-communicator analog)
            partitions = [
                p if p is not None else np.zeros(m.n_cells, np.int32)
                for p, m in zip(partitions, meshes)
            ]
        elif params.effective_policy_name():
            partitions = partition_hierarchy(
                params.effective_policy_name(), meshes, n_shards, problem.dofh
            )
        # reference-format per-level min/max/avg tables + summary values
        # (mg_tools.h:267-512, printed under verbose like the reference)
        stats = metrics.print_multigrid_statistics(
            meshes, n_shards, params.fe_degree_fine, partitions=partitions
        )
        for k, v in stats.items():
            table.add_value(k, v)

    if params.simulation_type == "Gaussian":
        u = problem.full_solution(result.x)
        table.add_value("l2_error", float(poisson.l2_error(problem, u)))


def _join_torchrun_group(device: torch.device) -> bool:
    """Under torchrun: join the gloo group (its address from the launcher's
    environment); True on a rank other than 0, which prints nothing."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    if device.type == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo")
    return dist.get_rank() != 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dealii_multigrid_tpu_torch.cli",
        description="Run each JSON parameter file and print the cumulative table.",
    )
    parser.add_argument("configs", nargs="*", metavar="input.json")
    parser.add_argument(
        "--device", default=None,
        help="torch device of the runs (default: cuda:0, an error without a card)",
    )
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if not args.configs:
        parser.print_usage()
        return 1
    table = ConvergenceTable()
    # exceptions print and abort with a nonzero exit, mirroring the
    # reference's try/catch in main (multigrid_throughput.cc:2444-2468)
    try:
        configs = [RunParameters.parse(path) for path in args.configs]
        device = resolve_device(args.device)
        quiet = _join_torchrun_group(device)
        if quiet:
            from .parallel.launch import rank_device

            device = rank_device(device.type, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]))
        out = contextlib.redirect_stdout(io.StringIO()) if quiet else contextlib.nullcontext()
        with out:
            print(f"device: {describe_device(device)}")
            for params in configs:
                run_config(params, table, device)
                table.write_text()
    except Exception as exc:  # noqa: BLE001
        print(f"error: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
