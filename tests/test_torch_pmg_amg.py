"""PMG with the smoothed-aggregation AMG coarse solve (the benchmark's
``pmg_amg_q4`` deployment), on the CPU at quadrant r=3 p=2.

The Q1 level there has 223 DoFs, so the direct-solver limit is lowered to
100 and the AMG's coarse size to 20, which gives the AMG two levels above
its dense coarsest (223, 174 and 171 rows).  Through the benchmark
harness's ``System`` the solve agrees with the plain reference; the AMG's
three phases split its application inside the multigrid's ``cs``, at every
AMG level, ``cs`` keeps only its own time beside them, so the V-cycle's
reading counts the AMG once, and timing them changes no bit; its set-up
spans sit inside the
coarse solver's; the least bytes of ``bench_h100/harness/amg_roofline.py``
are the count written out here; and a hierarchy without an AMG reads as
before.
"""

import functools
import importlib.util
import os
import sys
import time
import types

import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from dealii_multigrid_tpu_torch.solvers import amg as tamg, coarse
from dealii_multigrid_tpu_torch.utils import phases

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_h100")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
from harness import bench, system  # noqa: E402

CELL = "pmg_amg_q4.quadrant_r7"
AMG_SPANS = ("mgtpu.setup.amg_build", "mgtpu.setup.amg_upload", "mgtpu.setup.amg_factor")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(name: str):
    return _load(f"metrics/{name}.py", f"metric_{name}").read


def small_cell(name=CELL, **solver) -> bench.Cell:
    cell = bench.Cell.find(name)
    cell.traffic["mesh"] = dict(cell.traffic["mesh"], NRefGlobal=3)
    cell.config = dict(cell.config, solver=dict(cell.config["solver"], **solver))
    return cell


@pytest.fixture
def small_amg(monkeypatch):
    """An AMG on the Q1 level of quadrant r=3 with two levels above its
    dense coarsest."""
    monkeypatch.setattr(coarse, "DIRECT_SOLVER_MAX_DOFS", 100)
    monkeypatch.setattr(coarse, "build_amg", functools.partial(tamg.build_amg, coarse_size=20))


@pytest.fixture
def pmg(small_amg):
    phases.SETUP.clear()
    phases.AMG_SHAPE.clear()
    cell = small_cell(Degree=2)
    s = system.System(cell.params(), torch.device("cpu"))
    return s, s.mg.coarse_solve.inner          # the AMG in its slot wrapper


def test_solve_through_the_harness_agrees_with_the_reference(small_amg):
    phases.AMG_SHAPE.clear()
    out = bench.measure(small_cell(Degree=2), 2**31 + 17, 1.0, False, torch.device("cpu"),
                        time.perf_counter(), log=lambda s: None)
    shape = phases.AMG_SHAPE
    assert [lv["rows"] for lv in shape["levels"]] == [223, 174, 171] and shape["dense_rows"] == 171
    lim = {k: v["value"] for k, v in out["limits"].items()}
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert lim["true_residual"] <= 1e-4
    assert lim["first_step_residual"] < 0.5
    assert lim["residual_gap"] < 1e-12


def test_amg_phases_split_its_application_inside_cs(pmg):
    s, amg = pmg
    n_levels = len(amg.levels)
    assert n_levels >= 3 and amg.hook is phases.untimed
    rec = phases.PhaseRecorder(torch.device("cpu"))
    hooked = phases.instrument(s.precond, rec)
    b = s.rhs(1.0, 0.25)
    got, whole = rec.span(lambda: hooked.vmult(b))
    assert torch.equal(got, s.precond.vmult(b))
    # the original preconditioner's AMG keeps its default hook
    assert s.precond.mg.coarse_solve.inner.hook is phases.untimed
    assert hooked.mg.coarse_solve.inner.hook is rec
    recorded = {k for k in rec.level_seconds if k[0] in phases.AMG_PHASES}
    above = range(n_levels - 1)
    assert recorded == ({("amg_smooth", k) for k in above} | {("amg_transfer", k) for k in above}
                        | {("amg_dense", n_levels - 1)})
    amg_s = sum(rec.seconds[k] for k in phases.AMG_PHASES)
    assert amg_s > 0 and rec.seconds["cs"] >= 0
    # cs keeps its own time; the CLI's columns and table count the AMG in it
    assert rec.vcycle_seconds()["cs"] == pytest.approx(rec.seconds["cs"] + amg_s, rel=1e-12)
    table = rec.per_level()
    assert table["cs"] == [pytest.approx(rec.seconds["cs"] + amg_s, rel=1e-12)]
    # the per-level table keeps the multigrid's levels only
    assert all(len(v) == s.mg.n_levels - 1 for k, v in table.items() if k != "cs")
    # the benchmark's V-cycle reading sums every phase: the AMG counts once
    run = bench.Run(n_dofs=s.n_dofs, iterations=[1], phases=dict(rec.seconds))
    vc = _reader("vcycle.ms_per_it")(run)
    assert vc == pytest.approx(1e3 * sum(rec.vcycle_seconds().values()), rel=1e-12)
    assert vc <= 1e3 * whole
    assert _reader("amg.ms_per_it")(run) == pytest.approx(1e3 * amg_s, rel=1e-12)
    # a hooked AMG keeps the preconditioner out of a CUDA graph
    assert s.precond.mg.coarse_solve.graph_reason() is None
    assert hooked.mg.coarse_solve.graph_reason() == "hook"


def test_amg_spans_nest_inside_the_coarse_solve(pmg):
    s, amg = pmg
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.precond.vmult(s.rhs(1.0, 0.25))
    evs = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("mgtpu.")),
                 key=lambda e: e[1])
    cs = [e for e in evs if e[0] == "mgtpu.coarse.cs@L0"]
    mine = [e for e in evs if e[0].startswith("mgtpu.amg.")]
    assert len(cs) == 1 and mine
    assert {e[0] for e in mine} == (
        {f"mgtpu.amg.amg_{p}@A{k}" for p in ("smooth", "transfer") for k in range(len(amg.levels) - 1)}
        | {f"mgtpu.amg.amg_dense@A{len(amg.levels) - 1}"})
    assert all(cs[0][1] <= a and b <= cs[0][2] for _, a, b in mine)


def test_amg_setup_spans_sit_inside_the_coarse_span(pmg):
    recs = {r.parent + (r.name,): r for r in phases.SETUP.records()}
    mine = {p: r for p, r in recs.items() if r.name in AMG_SPANS}
    assert {p[-1] for p in mine} == set(AMG_SPANS)
    for path, r in mine.items():
        assert path[-2] == "mgtpu.setup.coarse" and r.count == 1
        assert r.seconds <= recs[path[:-1]].seconds
    # no span inside them, so their self times are their times
    run = types.SimpleNamespace(spans={"hierarchy_s": 1.0})
    assert _reader("setup.amg_s")(run) == pytest.approx(sum(r.seconds for r in mine.values()), rel=1e-12)


def test_amg_least_bytes_by_hand():
    roof = _load("harness/amg_roofline.py", "amg_roofline")
    # two levels: A0 100 rows with 460 entries, P 100 x 10 with 100 entries,
    # the dense coarsest 10 rows, 19 nonzeros in its lower triangle
    # (tridiagonal); float32 values and factor; 2 cycles, 2 sweeps
    shape = {"levels": [{"rows": 100, "nnz_A": 460, "nnz_P": 0},
                        {"rows": 10, "nnz_A": 100, "nnz_P": 100}],
             "value_dtype": "float32", "dense_rows": 10, "dense_nnz": 19,
             "factor_dtype": "float32", "n_cycles": 2, "n_smooth": 2}
    a_product = 460 * (4 + 4) + (100 + 100) * 4     # 4,480
    p_product = 100 * (4 + 4) + (100 + 10) * 4      # 1,240, as P^T and as P
    triangle = 19 * (4 + 4) + (10 + 10) * 4         # 232, each of the pair
    # 2 + 2 sweeps, the first from zero with no product, and the residual
    vcycle = 4 * a_product + 2 * p_product + 2 * triangle   # 20,864
    assert roof.least_bytes(shape) == 2 * vcycle + a_product == 46_208
    assert roof.least_ms(shape) == pytest.approx(1e3 * 46_208 / 3.35e12, rel=1e-15)
    # the record a real two-level build publishes
    n = 6
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n))
    A = (sp.kron(sp.identity(n), T) + sp.kron(T, sp.identity(n))).tocsr()
    phases.AMG_SHAPE.clear()
    built = tamg.build_amg(A, torch.float32, "cpu", coarse_size=20, n_cycles=2)
    rec = roof.built_shape()
    assert len(built.levels) == 2 and rec["levels"][0]["nnz_A"] == A.nnz == 156
    assert rec["levels"][1]["nnz_P"] == int((built.levels[1].P.vals != 0).sum())
    assert rec["dense_rows"] == built.chol.shape[0] == rec["levels"][1]["rows"]
    # the coarsest matrix's lower-triangle nonzeros, from its device table,
    # and no more than its factor holds
    Ac = built.levels[-1].A
    rows = torch.arange(Ac.shape[0]).unsqueeze(1)
    assert rec["dense_nnz"] == int(((Ac.vals != 0) & (Ac.idx <= rows)).sum())
    assert rec["dense_rows"] < rec["dense_nnz"] <= int(torch.count_nonzero(built.chol))
    assert (rec["value_dtype"], rec["factor_dtype"], rec["n_cycles"], rec["n_smooth"]) == (
        "float32", "float32", 2, 2)


def test_a_hierarchy_without_an_amg_reads_as_before():
    phases.SETUP.clear()
    s = system.System(small_cell("hmg_global_q4.quadrant_r7").params(), torch.device("cpu"))
    assert type(s.mg.coarse_solve) is coarse.DirectCoarseSolver
    rec = phases.PhaseRecorder(torch.device("cpu"))
    pre = s.instrumented(rec)
    its = sum(rec.span(lambda: s.solve(s.rhs(a, 0.5), pre))[0].n_iterations for a in (0.7, 1.3))
    assert all(rec.seconds[k] == 0.0 for k in phases.AMG_PHASES)
    # no phase runs inside another here, so each phase's own time is its
    # whole time, as the recorder read it before AMG phases existed
    depth, deepest = [0], [0]

    def nesting(phase, level, fn, *args):
        depth[0] += 1
        deepest[0] = max(deepest[0], depth[0])
        try:
            return fn(*args)
        finally:
            depth[0] -= 1

    s.solve(s.rhs(0.7, 0.5), s.instrumented(nesting))
    assert deepest[0] == 1
    run = bench.Run(n_dofs=s.n_dofs, iterations=[its], phases=dict(rec.seconds), spans={"x": 1.0})
    vc = 1e3 * sum(rec.seconds[k] for k in phases.VCYCLE_KEYS) / its
    assert _reader("vcycle.ms_per_it")(run) == pytest.approx(vc, rel=1e-12)
    assert _reader("coarse.ms_per_it")(run) == 1e3 * rec.seconds["cs"] / its
    assert _reader("amg.ms_per_it")(run) == 0.0 and _reader("amg.roofline")(run) is None
    # no AMG set-up span, so the solver's set-up reads its spans' self times
    recs = {r.parent + (r.name,): r for r in phases.SETUP.records()}
    assert not any("amg" in p[-1] for p in recs)
    assert _reader("setup.amg_s")(run) is None
    names = ("mgtpu.setup.transfer", "mgtpu.setup.eigenvalues", "mgtpu.setup.coarse",
             "mgtpu.setup.gc_preconditioner")
    kids = lambda p: sum(r.seconds for q, r in recs.items() if q[:-1] == p)  # noqa: E731
    expect = sum(r.seconds - kids(p) for p, r in recs.items() if p[-1] in names)
    assert _reader("setup.solver_s")(run) == pytest.approx(expect, rel=1e-12)


def _lap2d_amg():
    n = 6
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n))
    A = (sp.kron(sp.identity(n), T) + sp.kron(T, sp.identity(n))).tocsr()
    return tamg.build_amg(A, torch.float64, "cpu", coarse_size=20)


#: each wrapper of the AMG: (make it, find the AMG in it, its reason unhooked)
WRAPS = {
    "bare": (lambda a: a, lambda s: s, None),
    "slotted": (lambda a: coarse.SlottedSolver(a, torch.arange(36), torch.arange(36)),
                lambda s: s.inner, None),
    "cg_with_amg": (lambda a: coarse.make_cg_coarse_solver(
        None, coarse.SlottedSolver(a, torch.arange(36), torch.arange(36))),
        lambda s: s.preconditioner.inner, "coarse"),
}


@pytest.mark.parametrize("wrap", list(WRAPS))
def test_with_amg_hook_copies_the_amg_inside_each_coarse_solver(wrap):
    make, amg_in, reason = WRAPS[wrap]
    solver = make(_lap2d_amg())
    rec = phases.PhaseRecorder(torch.device("cpu"))
    hooked = solver.with_hook(rec)
    assert amg_in(hooked).hook is rec and hooked.graph_reason() == "hook"
    assert amg_in(solver).hook is phases.untimed and solver.graph_reason() == reason
    assert amg_in(hooked).levels is amg_in(solver).levels
    # hooking V-cycle phases only (``instrument``) leaves it as it is
    assert solver.with_hook(rec, phases.VCYCLE_KEYS) is solver
    # a coarse solver without an AMG is handed back as it is
    direct = coarse.DirectCoarseSolver(torch.eye(3, dtype=torch.float64))
    assert phases.hooked(direct, rec) is direct
