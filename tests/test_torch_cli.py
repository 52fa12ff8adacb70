"""The port's CLI, table, phase timers and host utilities (CPU).

The CLI on ``--device cpu`` must print the JAX CLI's columns in the JAX
CLI's order, with equal n_cells, n_cells_hn, n_dofs, n_levels and
n_iterations, and return 1 on a bad config.  The phase profilers return the
seven MG phases and the two boundary timers; ``edge_pro`` is zero on a
global-coarsening hierarchy and measured on a local-smoothing one (as
tests/test_phases.py holds the JAX package).  Partition metrics, policies
and the table format equal the JAX package's on the same meshes.
"""

import io
import json

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import cli as jcli
from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.parallel import metrics as jmetrics, partition as jpartition
from dealii_multigrid_tpu.utils.params import RunParameters as JParams
from dealii_multigrid_tpu.utils.table import ConvergenceTable as JTable
from dealii_multigrid_tpu_torch import api as tapi, cli as tcli
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.parallel import metrics as tmetrics, partition as tpartition
from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG, untimed
from dealii_multigrid_tpu_torch.utils import timer, vtu
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams
from dealii_multigrid_tpu_torch.utils.phases import (
    PHASES,
    format_per_level_table,
    profile_preconditioner,
    profile_preconditioner_per_level,
)
from dealii_multigrid_tpu_torch.utils.table import ConvergenceTable as TTable

BASE = {
    "GeometryType": "quadrant", "NRefGlobal": 2, "Degree": 2, "SmootherDegree": 3,
    "RelativeTolerance": 1e-4, "MGNumberType": "double", "NumberType": "double",
    "NRepetitions": 1, "CoarseGridSolverType": "amg",
}
CONFIGS = {
    "hmg_global_phases": {"Type": "HMG-global", "ProfilePhases": True, "Verbosity": False},
    "hpmg_local_gaussian": {
        "Type": "HPMG-local", "SimulationType": "Gaussian", "ProfilePhases": True,
        "Verbosity": False,
    },
    "hmg_local_policy": {"Type": "HMG-local", "PartitionerName": "CellWeightPolicy-2.0"},
    "pmg_cg_coarse": {"Type": "PMG", "CoarseGridSolverType": "cg_with_chebyshev"},
    "amg": {"Type": "AMG", "ProfilePhases": True},
    "amg_2d": {"Type": "AMGPETSc", "Dim": 2, "NRefGlobal": 3},
    "hpmg_2d": {"Type": "HPMG", "Dim": 2, "NRefGlobal": 3},
}


def write_config(tmp_path, name, **extra):
    path = tmp_path / f"input_{name}.json"
    path.write_text(json.dumps({**BASE, **CONFIGS.get(name, {}), **extra}))
    return str(path)


def parse_table(text: str) -> tuple[list, list]:
    """(header names, last row's cells) of the last table printed: values
    never hold a blank, so a split is enough for rows without empty cells."""
    lines = [ln for ln in text.splitlines() if ln.startswith(("dim ", "3 ", "2 "))]
    header = [ln for ln in lines if ln.startswith("dim ")][-1]
    return header.split(), lines[-1].split()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_prints_the_jax_cli_columns(tmp_path, capsys, name):
    path = write_config(tmp_path, name)
    jtable = JTable()
    jcli.run_config(JParams.parse(path), jtable)
    capsys.readouterr()
    assert tcli.main([path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu\n")
    header, row = parse_table(out)
    jrow = jtable.rows[0]
    assert header == list(jrow)                      # same columns, same order
    assert len(row) == len(header)
    trow = dict(zip(header, row))
    for key in ("dim", "type", "n_cells", "n_cells_hn", "n_cells_n", "n_dofs",
                "n_levels", "sub_comm_size", "n_iterations", "converged", "coarse_type",
                "policy"):
        assert trow[key] == str(jrow[key]), key
    if "l2_error" in jrow:
        assert abs(float(trow["l2_error"]) - jrow["l2_error"]) <= 1e-3 * jrow["l2_error"]
    if CONFIGS[name].get("ProfilePhases") and name != "amg":
        assert "time_pre" in header and "time_to_global" in header and "time_cg" in header
        assert float(trow["time_pre"]) > 0 and float(trow["time_post"]) > 0
        assert float(trow["time_cg"]) > 0
    else:
        assert "time_pre" not in header


def test_cli_table_is_cumulative(tmp_path, capsys):
    paths = [write_config(tmp_path, "amg"), write_config(tmp_path, "hmg_global_phases", Verbosity=True)]
    assert tcli.main(paths + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("\ndim ") == 2                  # printed after each config
    last = out[out.rindex("\ndim ") + 1:].splitlines()
    assert last[1].split()[1] == "AMG" and last[2].split()[1] == "HMG-global"
    assert "MG phases per level" in out and "Workload:" in out


@pytest.mark.parametrize("bad", ["bogus_type", "bad_geometry", "missing_file", "no_args", "no_card"])
def test_cli_returns_1_on_a_bad_config(tmp_path, capsys, bad):
    if bad == "bogus_type":
        argv = [write_config(tmp_path, "amg", Type="BOGUS"), "--device", "cpu"]
    elif bad == "bad_geometry":
        argv = [write_config(tmp_path, "amg", GeometryType="moebius"), "--device", "cpu"]
    elif bad == "missing_file":
        argv = [str(tmp_path / "nowhere.json"), "--device", "cpu"]
    elif bad == "no_args":
        argv = []
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        argv = [write_config(tmp_path, "amg")]       # no --device: the card
    assert tcli.main(argv) == 1
    captured = capsys.readouterr()
    assert "\ndim " not in captured.out
    if bad == "no_args":
        assert "usage" in captured.out
    else:
        assert captured.err.startswith("error: ")
    if bad == "no_card":
        assert "does not fall back" in captured.err


def test_cli_prints_the_amg_hierarchy(tmp_path, capsys, monkeypatch):
    from dealii_multigrid_tpu_torch.solvers import coarse

    monkeypatch.setattr(coarse, "DIRECT_SOLVER_MAX_DOFS", 100)
    path = write_config(tmp_path, "amg", NRefGlobal=3)      # 1,375 DoFs: two AMG levels
    assert tcli.main([path, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    top = lines.index("level rows K_A K_P K_PT bytes omega")
    assert lines[top - 1].startswith("AMG hierarchy (1 cycle(s)")
    first = lines[top + 1].split()
    assert first[:2] == ["0", "1375"] and int(first[2]) >= 27 and first[3:5] == ["0", "0"]
    assert int(lines[top + 2].split()[4]) >= 1               # P^T has its own table


def test_cli_writes_the_solution_file(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = write_config(tmp_path, "amg", Paraview=True)
    assert tcli.main([path, "--device", "cpu"]) == 0
    text = (tmp_path / "solution.vtu").read_text()
    assert text.startswith('<?xml version="1.0"?>') and 'NumberOfCells="15"' in text


def small_params(mg_type):
    p = TParams()
    p.type = mg_type
    p.geometry_type = "quadrant"
    p.n_ref_global = 2
    p.fe_degree_fine = 2
    p.number_type = "double"
    p.mg_number_type = "float"
    p.mg_data.smoother.degree = 3
    p.mg_data.n_repetitions = 1
    return p


def test_profile_gc_phases():
    res, _, _ = tapi.run(small_params("HMG-global"), "cpu")
    precond = PreconditionMG(res.mg, torch.float64)
    phases = profile_preconditioner(precond, res.rhs_used, n_loop=2)
    assert set(phases) == set(PHASES) | {"to_mg", "to_global"} and len(phases) == 9
    for ph in ("pre", "residuum", "post", "res", "pro", "cs", "to_mg", "to_global"):
        assert phases[ph] > 0.0
    assert phases["edge_pro"] == 0.0                 # GC has no edge operators
    per_level = profile_preconditioner_per_level(precond, res.rhs_used, n_loop=2)
    L = res.mg.n_levels - 1
    for ph in ("pre", "residuum", "res", "pro", "post", "edge_pro"):
        assert len(per_level[ph]) == L
    assert len(per_level["cs"]) == 1 and per_level["edge_pro"] == [0.0] * L
    lines = format_per_level_table(per_level).splitlines()
    assert lines[0].split() == ["level", "pre", "residuum", "res", "pro", "edge_pro", "post"]
    assert len(lines) == L + 2 and lines[-1].startswith("coarse solve:")


@pytest.mark.parametrize("mg_type", ["HMG-local", "HPMG-local"])
def test_profile_ls_phases(mg_type):
    res, _, _ = tapi.run(small_params(mg_type), "cpu")
    phases = profile_preconditioner(res.ls_mg, res.rhs_used, n_loop=2)
    assert set(phases) == set(PHASES) | {"to_mg", "to_global"}
    assert phases["edge_pro"] > 0.0                  # refinement-edge operators
    assert phases["to_mg"] > 0.0 and phases["to_global"] > 0.0
    per_level = profile_preconditioner_per_level(res.ls_mg, res.rhs_used, n_loop=2)
    assert len(per_level["edge_pro"]) == len(res.ls_mg.levels) - 1
    assert all(t > 0.0 for t in per_level["edge_pro"])


@pytest.mark.parametrize(
    "mg_type,dim", [("HMG-global", 3), ("HPMG-local", 3), ("HMG-local", 3), ("HMG-global", 2)]
)
def test_time_cg_comes_from_the_instrumented_solve(tmp_path, capsys, mg_type, dim):
    """ProfilePhases runs one more solve whose V-cycle phases are timed
    inside it: the phases sum to at most its iteration time, time_cg is the
    difference (> 0), and the timed solves stay uninstrumented.  (The JAX
    CLI prints no phase columns in 2D; the port does.)"""
    prm = small_params(mg_type)
    prm.dim = dim
    prm.profile_phases = True
    res, _, _ = tapi.run(prm, "cpu")
    assert set(res.phases) == set(PHASES) | {"to_mg", "to_global"}
    assert 0 < sum(res.phases.values()) <= res.phase_iteration_time
    assert res.mg is None or res.mg.hook is untimed
    assert res.ls_mg is None or res.ls_mg.hook is untimed
    path = write_config(tmp_path, "hmg_global_phases", Type=mg_type, MGNumberType="float", Dim=dim)
    assert tcli.main([path, "--device", "cpu"]) == 0
    header, row = parse_table(capsys.readouterr().out)
    trow = dict(zip(header, row))
    phase_sum = sum(float(trow[f"time_{k}"]) for k in res.phases)
    assert float(trow["time_cg"]) > 0 and phase_sum > 0


def test_phase_vectors_are_consistent_and_seeded():
    """Duplicate slots of a phase input carry one value, drawn from the
    documented seed in the global layout."""
    from dealii_multigrid_tpu_torch.utils.phases import _consistent_random

    res, _, levels = tapi.run(small_params("HMG-global"), "cpu")
    op, fmt = levels[-1].op, levels[-1].fmt
    v = _consistent_random(op, torch.float64, 101).numpy()
    g = np.random.default_rng(101).standard_normal(op.n_dofs)
    assert fmt.n_slots > op.n_dofs                   # the layout has duplicates
    real = fmt.slot_dof < op.n_dofs
    assert np.array_equal(v[real], g[fmt.slot_dof[real]]) and not v[~real].any()


def meshes_of(G, r=3):
    from_fine = [G.create("quadrant", 3, k) for k in (1, 2, r)]
    return from_fine


@pytest.mark.parametrize("policy", [
    "", "DefaultPolicy", "BalancedGranularityPartitionPolicy", "MinimalGranularityPolicy-10",
    "CellWeightPolicy-2.0", "FirstChildPolicy",
])
def test_partitions_and_statistics_equal_jax(policy):
    jm, tm = meshes_of(JG), meshes_of(TG)
    jd, td = JD.distribute_dofs(jm[-1], 2), TD.distribute_dofs(tm[-1], 2)
    jp = jpartition.partition_hierarchy(policy, jm, 4, jd)
    tp = tpartition.partition_hierarchy(policy, tm, 4, td)
    assert all(np.array_equal(a, b) for a, b in zip(jp, tp))
    js = jmetrics.multigrid_statistics(jm, 4, 2, partitions=jp)
    ts = tmetrics.multigrid_statistics(tm, 4, 2, partitions=tp)
    assert ts == js
    jout, tout = io.StringIO(), io.StringIO()
    jmetrics.print_multigrid_statistics(jm, 4, 2, partitions=jp, stream=jout)
    assert tmetrics.print_multigrid_statistics(tm, 4, 2, partitions=tp, stream=tout) == ts
    assert tout.getvalue() == jout.getvalue()


def test_table_formats_like_jax():
    rows = [{"a": 1, "time": 0.012345, "big": 123456.0}, {"a": 22, "zero": 0.0, "tiny": 1.5e-5}]
    jt, tt = JTable(), TTable()
    for t in (jt, tt):
        for row in rows:
            t.new_row()
            for k, v in row.items():
                t.add_value(k, v)
    assert tt.to_text() == jt.to_text()
    assert TTable().to_text() == ""


def test_timer_and_memory_monitor(capsys):
    acc = [0.0, 0.0]
    with timer.ScopedTimer(acc, 1):
        sum(range(1000))
    assert acc[0] == 0.0 and acc[1] > 0.0
    assert "VmRSS" in timer.host_memory_stats()
    stats = timer.device_memory_stats()
    if torch.cuda.is_available():
        assert all(s["peak_bytes_in_use"] >= s["bytes_in_use"] for s in stats.values())
    else:
        assert stats == {}
    timer.monitor("quiet")
    assert capsys.readouterr().out == ""
    timer.set_monitor(True)
    try:
        timer.monitor("loud")
    finally:
        timer.set_monitor(False)
    assert capsys.readouterr().out.startswith("[monitor] loud: ")


def test_vtu_refuses_2d(tmp_path):
    dofh = TD.distribute_dofs(TG.create("quadrant", 2, 2), 1)
    with pytest.raises(NotImplementedError, match="3D"):
        vtu.write_vtu(str(tmp_path / "x.vtu"), dofh, np.zeros(dofh.n_dofs))
