"""The port's spans (utils/phases.py) and the benchmark's reader of them
(bench_h100/harness/spans.py), on the CPU.

Under a recording profiler an r=2 solve names every V-cycle phase at its
level, each whole preconditioner application, each CG iteration and the
hybrid operator's parts, nested as the calls nest; without one no range is
entered.  The range records a CPU event that is not a user annotation (a
``record_function`` range is one, and on CUDA it is mirrored onto the
device's timeline).  The phase recorder's per-level sums add up to its
per-phase sums and are the CLI's verbose table.  The set-up spans are kept
with their parents and counts, inside the time of the call that made them,
and the set-up metrics are the self times of the spans they name.  The
launch metrics count the launches that start inside their spans, a CUDA
graph's launch as one, and no launch outside every span.
"""

import importlib.util
import os
import re
import sys
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dealii_multigrid_tpu_torch import api, cli
from dealii_multigrid_tpu_torch.utils import phases
from dealii_multigrid_tpu_torch.utils.params import RunParameters

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_h100")
NAME = re.compile(r"^mgtpu\.[a-z_]+\.[a-z_]+(@L\d+)?$")
OPERATOR_PARTS = {"apply_c", "cell_apply", "apply_ct_faces", "exchange", "apply_ct"}


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass resolves its annotations there
    spec.loader.exec_module(mod)
    return mod


def small(mg_type: str) -> RunParameters:
    p = RunParameters()
    p.type = mg_type
    p.geometry_type = "quadrant"
    p.n_ref_global = 2
    p.fe_degree_fine = 2
    p.number_type = "double"
    p.mg_number_type = "float"
    p.mg_data.n_repetitions = 1
    return p


class Ev:
    def __init__(self, e):
        self.name, self.start = e.name(), e.start_ns()
        self.end = self.start + e.duration_ns()
        self.parent = None


def solve_spans(prof) -> list:
    """The solve path's spans of a profile, each with its innermost
    enclosing span (set-up spans included) as ``parent``."""
    evs = sorted(
        (Ev(e) for e in prof.profiler.kineto_results.events() if e.name().startswith("mgtpu.")),
        key=lambda e: (e.start, -e.end),
    )
    stack: list = []
    for e in evs:
        while stack and stack[-1].end < e.start:
            stack.pop()
        if stack and e.end <= stack[-1].end:
            e.parent = stack[-1]
        stack.append(e)
    return [e for e in evs if not e.name.startswith("mgtpu.setup.")]


def parent_name(e) -> str | None:
    return None if e.parent is None else e.parent.name


@pytest.mark.parametrize("mg_type", ["HMG-global", "HMG-local", "HPMG-local"])
def test_solve_spans_name_levels_and_nest(mg_type):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, _, _ = api.run(small(mg_type), "cpu")
    found = solve_spans(prof)
    assert found and all(NAME.match(e.name) for e in found)
    its = [e for e in found if e.name == phases.CG_ITERATION]
    assert len(its) == sum(res.solve_iterations)
    assert all(parent_name(e) == phases.CG_SOLVE for e in its)
    assert all(parent_name(e) is None for e in found if e.name == phases.CG_SOLVE)
    # the outer preconditioner once an iteration; HPMG-local's LS V-cycle
    # is its p-levels' coarse solve
    pre = [e for e in found if e.name == phases.PRECONDITION]
    assert {parent_name(e) for e in pre} == (
        {phases.CG_ITERATION, "mgtpu.coarse.cs@L0"} if mg_type == "HPMG-local" else {phases.CG_ITERATION}
    )
    assert sum(parent_name(e) == phases.CG_ITERATION for e in pre) == len(its)
    levels = {}
    for e in found:
        if "@L" in e.name:
            body, level = e.name.split("@L")
            assert parent_name(e) == phases.PRECONDITION, e.name
            assert body == phases.phase_span_name(body.rsplit(".", 1)[1], None)
            levels.setdefault(int(level), set()).add(body.rsplit(".", 1)[1])
    top = max(levels)
    assert levels[0] >= {"cs"} and levels[top] >= {"to_mg", "to_global"}
    level_phases = {"pre", "residuum", "res", "pro", "post"}
    if mg_type != "HMG-global":
        level_phases.add("edge_pro")
    assert all(levels[lv] >= level_phases for lv in range(1, top + 1))
    parts = [e for e in found if e.name.startswith("mgtpu.operator.") and "@L" not in e.name]
    assert {e.name.rsplit(".", 1)[1] for e in parts} == OPERATOR_PARTS
    for e in parts:
        outer = parent_name(e)
        # a phase, the outer CG's vmult, the eigenvalue estimates of the
        # set-up, or (outside every span) the residual check after the solves
        assert (outer is None or "@L" in outer or outer == phases.CG_ITERATION
                or outer == "mgtpu.setup.eigenvalues"), outer


def application_spans(prof) -> list:
    """Each span of a profile but the operator's parts, in order, as
    (name less ``mgtpu.``, its enclosing span's, the operator parts whose
    innermost other span it is)."""
    rows, owner = [], {}
    for e in solve_spans(prof):
        if e.name[len("mgtpu.operator."):] in OPERATOR_PARTS:
            outer = e.parent
            while outer is not None and outer.name[len("mgtpu.operator."):] in OPERATOR_PARTS:
                outer = outer.parent
            owner[outer][2] += 1
            continue
        owner[e] = [e.name[6:], parent_name(e) and parent_name(e)[6:], 0]
        rows.append(owner[e])
    return [tuple(r) for r in rows]


def _vcycle(top: int, edge: bool) -> list:
    """A V-cycle's spans from level ``top`` down to a coarse solve without
    phases of its own, as ``application_spans`` lists them (r=2 p=2)."""
    P = "vcycle.precondition"
    down, up = [], []
    for lv in range(top, 0, -1):
        down += [(f"smoother.pre@L{lv}", P, 20), (f"operator.residuum@L{lv}", P, 5)]
        down += [(f"ls_interface.edge_pro@L{lv}", P, 2)] if edge else []
        down += [(f"transfer.res@L{lv}", P, 0)]
        up = ([(f"transfer.pro@L{lv}", P, 0)] + ([(f"ls_interface.edge_pro@L{lv}", P, 2)] if edge else [])
              + [(f"smoother.post@L{lv}", P, 25)]) + up
    return ([(P, None, 0), (f"vcycle.to_mg@L{top}", P, 0)] + down + [("coarse.cs@L0", P, 0)] + up
            + [(f"vcycle.to_global@L{top}", P, 0)])


def _amg_cycle(n: int) -> list:
    """An AMG coarse solve's spans inside ``cs``: ``n`` levels, one cycle."""
    cs = "coarse.cs@L0"
    down = [row for k in range(n - 1)
            for row in ((f"amg.amg_smooth@A{k}", cs, 0), (f"amg.amg_transfer@A{k}", cs, 0))]
    up = [row for k in reversed(range(n - 1))
          for row in ((f"amg.amg_transfer@A{k}", cs, 0), (f"amg.amg_smooth@A{k}", cs, 0))]
    return down + [(f"amg.amg_dense@A{n - 1}", cs, 0)] + up


def _pmg_amg() -> list:
    spans = _vcycle(1, False)
    at = spans.index(("coarse.cs@L0", "vcycle.precondition", 0)) + 1
    return spans[:at] + _amg_cycle(3) + spans[at:]


#: one application's spans: HMG-global and HMG-local at quadrant r=2 p=2,
#: PMG at r=3 p=2 with the AMG on its Q1 level (three AMG levels)
APPLICATION_SPANS = {
    "HMG-global": _vcycle(2, False),
    "HMG-local": _vcycle(2, True),
    "PMG": _pmg_amg(),
}


@pytest.mark.parametrize("path", ["eager", "instrumented", "debug"])
@pytest.mark.parametrize("mg_type", list(APPLICATION_SPANS))
def test_one_application_records_the_same_spans_on_every_path(monkeypatch, mg_type, path):
    """One application of the preconditioner, eager on the CPU, as it is,
    as the phase recorder's copy and as debug mode's checked copy: the
    same spans, in the same order and nesting, with the same operator
    parts inside each."""
    import functools

    from dealii_multigrid_tpu_torch.solvers import amg, coarse

    prm = small(mg_type)
    if mg_type == "PMG":
        monkeypatch.setattr(coarse, "DIRECT_SOLVER_MAX_DOFS", 100)
        monkeypatch.setattr(coarse, "build_amg", functools.partial(amg.build_amg, coarse_size=20))
        prm.n_ref_global = 3
        prm.mg_data.coarse_solver.type = "amg"
    res, _, levels = api.run(prm, "cpu")
    if res.mg is not None:
        precond = api.PreconditionMG(res.mg, torch.float64)
    else:
        precond = api.PreconditionLS(res.ls_mg, levels[-1].op.constrained_keep, torch.float64)
    if path == "instrumented":
        precond = phases.instrument(precond, phases.PhaseRecorder(torch.device("cpu")))
    elif path == "debug":
        monkeypatch.setenv("MGTPU_DEBUG", "1")
        precond = phases.checked(precond)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        precond.vmult(res.rhs_used)
    assert application_spans(prof) == APPLICATION_SPANS[mg_type]


class _Refused:
    def __init__(self, name):
        raise RuntimeError(f"a profiler range was entered: {name}")


@pytest.mark.parametrize("mg_type", ["HMG-global", "HMG-local", "HPMG-local"])
def test_no_range_without_a_profiler(monkeypatch, mg_type):
    monkeypatch.setattr(phases, "_RecordFunctionFast", _Refused)
    res, _, _ = api.run(small(mg_type), "cpu")
    assert res.converged
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="profiler range was entered: mgtpu.setup.mesh"):
            api.run(small(mg_type), "cpu")


def test_range_records_a_cpu_event_only():
    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with phases.span(phases.CG_ITERATION):
            phases.untimed("pre", 3, torch.add, x, 1.0)
            phases.spanned("mgtpu.operator.exchange", torch.mul, x, 2.0)
    ours = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("mgtpu.")]
    assert sorted(e.name() for e in ours) == [
        "mgtpu.cg.iteration", "mgtpu.operator.exchange", "mgtpu.smoother.pre@L3",
    ]
    cpu = torch.autograd.DeviceType.CPU
    assert all(e.device_type() == cpu and not e.is_user_annotation() for e in ours)


@pytest.mark.parametrize("mg_type", ["HMG-global", "HPMG-local"])
def test_per_level_sums_equal_phase_sums_and_make_the_verbose_table(mg_type, tmp_path, capsys):
    rec = phases.PhaseRecorder(torch.device("cpu"))
    prm = small(mg_type)
    res, _, _ = api.run(prm, "cpu")
    precond = phases.instrument(api.PreconditionMG(res.mg, torch.float64), rec)
    rec.span(lambda: precond.vmult(res.rhs_used))
    assert rec.seconds["pre"] > 0.0
    for ph in phases.KEYS:
        by_level = sum(s for (p, _), s in rec.level_seconds.items() if p == ph)
        assert by_level == pytest.approx(rec.seconds[ph], rel=1e-12, abs=0.0)
    table = rec.per_level()
    assert len(table["pre"]) == res.mg.n_levels - 1 and len(table["cs"]) == 1
    assert sum(table["residuum"]) == pytest.approx(rec.seconds["residuum"], rel=1e-12)
    # the CLI prints its instrumented solve's per-level sums in this table
    path = tmp_path / "input.json"
    path.write_text(
        '{"Type": "%s", "GeometryType": "quadrant", "NRefGlobal": 2, "Degree": 2, '
        '"NRepetitions": 1, "ProfilePhases": true, "Verbosity": true}' % mg_type
    )
    assert cli.main([str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    printed = out[out.index("MG phases per level"):].splitlines()[1:]
    expect = phases.format_per_level_table(table).splitlines()
    assert printed[0] == expect[0]
    assert [ln.split()[0] for ln in printed[1:len(expect) - 1]] == [
        str(lv) for lv in range(1, res.mg.n_levels)
    ]
    assert printed[len(expect) - 1].startswith("coarse solve:")


def test_setup_spans_keep_names_parents_and_counts():
    phases.SETUP.clear()
    t0 = time.perf_counter()
    res, _, levels = api.run(small("HMG-global"), "cpu")
    elapsed = time.perf_counter() - t0
    recs = {r.parent + (r.name,): r for r in phases.SETUP.records()}
    n = len(levels)
    L = "mgtpu.setup.level"
    assert recs[(L,)].count == n
    for leaf in ("dofs", "hanging", "hybrid_format", "hybrid_operator", "diagonal"):
        assert recs[(L, "mgtpu.setup." + leaf)].count == n
    assert recs[("mgtpu.setup.mesh",)].count == 1
    assert recs[("mgtpu.setup.coarsening",)].count == 1
    gc = "mgtpu.setup.gc_preconditioner"
    assert recs[(gc, "mgtpu.setup.transfer")].count == n - 1
    assert recs[(gc, "mgtpu.setup.eigenvalues")].count == 1
    assert ("mgtpu.setup.outer_problem", "mgtpu.setup.rhs") in recs
    leaves = [r for p, r in recs.items() if not any(q[:-1] == p for q in recs)]
    outermost = sum(r.seconds for r in recs.values() if not r.parent)
    assert 0 < sum(r.seconds for r in leaves) <= outermost <= elapsed
    # the set-up metrics: self times of the spans each names, disjoint
    run = types.SimpleNamespace(spans={"hierarchy_s": 1.0})
    total = 0.0
    for name in ("setup.mesh_s", "setup.dofs_s", "setup.format_s", "setup.solver_s"):
        mod = _load(f"metrics/{name}.py", "metric_" + name)
        mine = [p for p in recs if p[-1] in mod.SPANS]
        kids = lambda p: sum(r.seconds for q, r in recs.items() if q[:-1] == p)  # noqa: E731
        expect = sum(recs[p].seconds - kids(p) for p in mine)
        assert mod.read(run) == pytest.approx(expect, rel=1e-12)
        total += expect
    assert 0 < total <= outermost
    assert mod.read(types.SimpleNamespace(spans={})) is None  # no set-up in the run


def _trace(extra):
    Trace = _load("harness/trace.py", "bench_h100_trace").Trace
    host = [
        ("mgtpu.cg.solve", 0.0, 20.0),
        ("mgtpu.cg.iteration", 1.0, 10.0),
        ("mgtpu.vcycle.precondition", 1.5, 8.0),
        ("mgtpu.smoother.pre@L2", 2.0, 4.0),
        ("mgtpu.operator.exchange", 2.5, 3.0),
        ("cudaLaunchKernel", 2.6, 2.61),        # exchange < pre@L2 < precondition < iteration
        ("mgtpu.smoother.pre@L1", 4.5, 5.0),
        ("cudaLaunchKernel", 4.6, 4.61),        # pre@L1 (a lower level)
        ("mgtpu.operator.apply_c", 5.5, 6.0),
        ("cudaLaunchKernel", 5.6, 5.61),        # constraints, no phase
        ("cudaLaunchKernel", 9.0, 9.01),        # the iteration only: the CG's own
    ] + extra
    return Trace(window_s=1.0, iterations=1, device=[("k", 0.0, 1.0)], host=host)


BASE = {"smoother.launches_per_it": 2, "exchange.launches_per_it": 1,
        "constraints.launches_per_it": 1, "cg.launches_per_it": 1,
        "vcycle.lower_levels_launches_per_it": 1, "transfer.launches_per_it": None}
CASES = {
    "nested": ([], {}),
    "outside_every_span": ([("cudaLaunchKernel", 30.0, 30.01)], {}),
    "graph": ([("cudaGraphLaunch", 3.5, 3.51)], {"smoother.launches_per_it": 3}),
    # an AMG coarse solve's phase, named by the port, inside cs@L0: its level
    # is the AMG's own (6), which no reader takes for a multigrid level, so
    # L2 stays the top and the launch counts once, as the coarse solve's
    "amg_coarse_solve": ([("mgtpu.coarse.cs@L0", 6.5, 7.5),
                          (phases.phase_span_name("amg_smooth", 6), 6.6, 7.0),
                          ("cudaLaunchKernel", 6.7, 6.71)],
                         {"vcycle.lower_levels_launches_per_it": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_launch_metrics_on_a_synthetic_trace(case):
    extra, changed = CASES[case]
    run = types.SimpleNamespace(trace=_trace(extra), local_smoothing=False)
    for name, want in dict(BASE, **changed).items():
        mod = _load(f"metrics/{name}.py", "metric_" + name)
        assert mod.read(run) == want, (case, name)
    spans = _load("harness/spans.py", "bench_h100_spans")
    t = run.trace
    inside = spans.count_inside(spans.launches(t), spans.spans(t))
    assert len(spans.launches(t)) - inside == (1 if case == "outside_every_span" else 0)
