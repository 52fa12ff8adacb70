"""A CPU rehearsal of whole runs at quadrant r=3 (which print no device
metric), the faults and the control that the check has to catch, and the
run's modules and files."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from harness import bench, system

R_TEST = 3  # quadrant r=3: 120 cells, 9,295 DoFs, 4 levels
with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def small(name: str, r=None, **solver) -> bench.Cell:
    cell = bench.Cell.find(name)
    r = r if r is not None else R_TEST if "quadrant" in name else 2
    cell.traffic["mesh"] = dict(cell.traffic["mesh"], NRefGlobal=r)
    cell.config = dict(cell.config, solver=dict(cell.config["solver"], **solver))
    return cell


def rehearse(cell, trace=False, seed=2**31 + 11, seconds=1.5):
    return bench.measure(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                         log=lambda s: None)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_rehearsal(name, trace):
    out = rehearse(small(name), trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "limits"}
    assert list(out)[-1] == "limits"
    assert out["device"]["platform"] == "cpu"
    m = out["metrics"]
    if trace:
        assert {"cg.iterations", "vcycle.ms_per_it", "setup.precond_s"} <= set(m)
        assert ("ls_interface.ms_per_it" in m) == name.startswith("hmg_local")
        # device metrics come from a card's trace only
        assert not {"stencil_roofline", "device.idle_share", "device.kernels_per_it", "device.busy_ms_per_it"} & set(m)
    else:
        assert {"setup_s", "dof_solves_per_s", "solve_ms_p90"} <= set(m)
        assert "peak_mem_gib" not in m


def _zero_answer(self, b, precond=None):
    res = _solve(self, b, precond)
    return res._replace(x=torch.zeros_like(res.x))


def _altered_answer(self, b, precond=None):
    res = _solve(self, b, precond)
    return res._replace(x=res.x * (1.0 + 1e-3))


def _half_the_load(self, alpha, beta):
    # the constant half of the load mix left out
    return _rhs(self, 0.0, beta)


def _altered_after_a_dozen(self, b, precond=None):
    # sound for the warm-up and the window's first dozen solves (the ones
    # the seed draws from), altered from then on
    res = _solve(self, b, precond)
    self.n_solved = getattr(self, "n_solved", 0) + 1
    return res if self.n_solved <= 13 else res._replace(x=res.x * (1.0 + 1e-3))


_solve, _rhs = system.System.solve, system.System.rhs
FAULTS = {
    "state_unchanged": ("solve", _zero_answer),
    "answer_altered": ("solve", _altered_answer),
    "answer_altered_after_a_dozen": ("solve", _altered_after_a_dozen),
    "half_the_load_left_out": ("rhs", _half_the_load),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    attr, fn = FAULTS[fault]
    monkeypatch.setattr(system.System, attr, fn)
    out = rehearse(small("hmg_global_q4.quadrant_r7", r=2), seconds=4.0)
    if fault == "answer_altered_after_a_dozen":
        assert out["solves_in_window"] > 13
    assert not out["correct"], out["limits"]


#: every Type and number type the harness wires besides the cells' own
#: (HMG-global and HMG-local, double over float)
WIRED = [
    ("PMG", {}),
    ("HPMG", {}),
    ("HPMG-local", {}),
    ("HMG-global", {"NumberType": "df32"}),
    ("HMG-global", {"NumberType": "mixed"}),
    ("HMG-global", {"NumberType": "float"}),
    ("HMG-global", {"MGNumberType": "double"}),
    ("HMG-global", {"MGNumberType": "bfloat16"}),
    ("HMG-local", {"NumberType": "df32"}),
    ("HMG-local", {"MGNumberType": "double"}),
]


@pytest.mark.parametrize("typ,numbers", WIRED, ids=[f"{t}-{'-'.join(n.values()) or 'default'}" for t, n in WIRED])
def test_every_wired_type_solves_and_agrees_with_the_reference(typ, numbers):
    """quadrant r=2: the run converges, the reference reads the answer
    within the tolerance and a V-cycle that reduces the residual, and the
    answer is what the CG reports to its outer type's precision."""
    out = rehearse(small("hmg_global_q4.quadrant_r7", r=2, Type=typ, **numbers))
    lim = {k: v["value"] for k, v in out["limits"].items()}
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert lim["true_residual"] <= out["limits"]["true_residual"]["limit"]
    assert lim["first_step_residual"] < 0.5
    assert lim["residual_gap"] < (1e-12 if numbers.get("NumberType", "double") == "double" else 1e-5)


@pytest.mark.parametrize("typ,dim", [("AMG", 3), ("AMGPETSc", 3), ("HMG-global", 2)])
def test_unwired_types_are_refused(typ, dim):
    cell = small("hmg_global_q4.quadrant_r7", r=2, Type=typ, Dim=dim)
    with pytest.raises(ValueError, match="not wired"):
        system.System(cell.params(), torch.device("cpu"))


def test_vcycle_that_leaves_its_input_unchanged_is_not_correct(monkeypatch):
    # the solve still converges (more iterations); the first step shows it
    class Identity:
        @staticmethod
        def vmult(b):
            return b

    init = system.System.__init__

    def identity_preconditioner(self, *a, **k):
        init(self, *a, **k)
        self.wrapper = system.FirstApply(Identity())

    monkeypatch.setattr(system.System, "__init__", identity_preconditioner)
    out = rehearse(small("hmg_global_q4.quadrant_r7"))
    assert not out["correct"]
    assert out["limits"]["first_step_residual"]["value"] > out["limits"]["first_step_residual"]["limit"]


def test_control_float32_outer_cg_is_not_correct():
    # the configuration states a float64 outer CG; float32 meets the
    # tolerance, but its answer parts from the residual it reports
    out = rehearse(small("hmg_global_q4.quadrant_r7", NumberType="float"))
    assert not out["correct"]
    assert out["limits"]["residual_gap"]["value"] > out["limits"]["residual_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("variant", ["control_bf16", "control_float"])
def test_controls_at_the_cells_own_size(cuda, name, variant):
    """On the card: each control, on one seed at the cell's own size, fails
    one of the cell's numbers (bfloat16 levels: the V-cycle's first step;
    a float32 outer CG: the residual gap or the true residual)."""
    from harness import check
    from tools import readings

    cell = bench.Cell.find(name)
    seed = 2**31 + 4242
    samples = readings.samples_for(cell, readings.VARIANTS[variant], [seed], cuda, variant)[seed]
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.mesh.dof import distribute_dofs

    p = cell.params()
    points = distribute_dofs(generators.create(p.geometry_type, 3, p.n_ref_global), p.fe_degree_fine).points
    got = check.Referee(cell.config["reference"], cell.traffic["mesh"], p.fe_degree_fine, cuda).read(points, samples)
    limits = dict(cell.limits, true_residual=cell.config["solver"]["RelativeTolerance"])
    ok, table = check.judge(got, limits, 0)
    assert not ok, table


SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{here!r}, {root!r}]
mode = sys.argv[1]
if mode == "reference":
    from reference import poisson_q
    import torch
    P = poisson_q.PoissonQ(poisson_q.build_mesh("quadrant", 2), 2, "cpu")
    P.load("Gaussian")
else:
    import torch
    from harness import bench, check, roofline, system, trace, traffic
    cell = bench.Cell.find("hmg_local_q4.quadrant_r7")
    cell.traffic["mesh"]["NRefGlobal"] = 2
    bench.measure(cell, 5, 0.2, True, torch.device("cpu"), time.perf_counter(), log=lambda s: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(mode, env):
    code = SCRIPT.format(here=bench.HERE, root=bench.ROOT)
    out = subprocess.run([sys.executable, "-c", code, mode], capture_output=True, text=True,
                         timeout=600, env=env, cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _listing(path):
    try:
        return set(os.listdir(path))
    except OSError:
        return set()


def test_no_jax_and_files_stay_in_the_checkout(tmp_path):
    env = dict(os.environ, HOME=str(tmp_path / "home"), XDG_CACHE_HOME=str(tmp_path / "cache"),
               TMPDIR=str(tmp_path / "tmp"))
    for d in ("home", "cache", "tmp"):
        (tmp_path / d).mkdir()
    before = {p: _listing(p) for p in ("/tmp", "/dev/shm")}
    tops = _run("harness", env)
    assert not tops & set(bench.FORBIDDEN), tops & set(bench.FORBIDDEN)
    assert "dealii_multigrid_tpu_torch" in tops and "torch" in tops
    ref = _run("reference", env)
    assert not ref & (set(bench.FORBIDDEN) | {"dealii_multigrid_tpu_torch"})
    for p, names in before.items():
        new = _listing(p) - names
        assert not {n for n in new if not n.startswith(("pytest-", "tmp"))}, (p, new)
