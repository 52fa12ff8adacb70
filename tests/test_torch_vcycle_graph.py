"""The preconditioners' CUDA graphs (solvers/vcycle_graph.py), on the CPU.

There is no card here, so the rules that decide between replay and an eager
application are checked on hierarchies of stand-in parts: each object
answers ``graph_reason()`` for itself, and each rule alone selects the
eager path and counts its reason.  The replay's own bookkeeping (the cast
into the static vector, a fresh output, the counts, the kernels' launches)
is checked with a stand-in graph.  A phase-recorder copy made by ``instrument`` neither
shares nor inherits its original's graph, and on the CPU the
preconditioners build no graph and apply exactly the eager V-cycle (the
card's tests, tests/test_torch_cuda.py, hold the replay to it bit for bit).
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from dealii_multigrid_tpu_torch import api
from dealii_multigrid_tpu_torch.ops import kernels
from dealii_multigrid_tpu_torch.parallel.sharding import GatheredSolve
from dealii_multigrid_tpu_torch.solvers import vcycle_graph as vg
from dealii_multigrid_tpu_torch.solvers.cg import cg_solve
from dealii_multigrid_tpu_torch.solvers.coarse import (
    CGCoarseSolver,
    DirectCoarseSolver,
    SlottedSolver,
)
from dealii_multigrid_tpu_torch.solvers.local_smoothing import LocalSmoothingMGHybrid, LSHybridLevel
from dealii_multigrid_tpu_torch.solvers.multigrid import Multigrid, PreconditionMG
from dealii_multigrid_tpu_torch.utils import phases
from dealii_multigrid_tpu_torch.utils.params import RunParameters

CUDA = torch.device("cuda:0")  # a device name only: nothing here runs on a card


@pytest.fixture(autouse=True)
def counts(monkeypatch):
    """Fresh graph counts, and a stream that is not capturing (the CPU
    build of torch cannot answer the question)."""
    monkeypatch.setattr(phases, "GRAPHS", phases.GraphCounts())
    monkeypatch.setattr(vg, "GRAPHS", phases.GRAPHS)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return phases.GRAPHS


def direct():
    return DirectCoarseSolver(torch.eye(3))


def hierarchy(coarse=None, hook=phases.untimed, parts=()):
    """A multigrid hierarchy of the stand-in operators ``parts``."""
    return Multigrid(tuple(parts), (), (), direct() if coarse is None else coarse, hook)


def ls_level(op):
    """A local-smoothing level over the stand-in operator ``op``."""
    return LSHybridLevel(op, *[None] * 7, n_dofs=0, fmt=None)


def test_a_sound_hierarchy_has_no_reason():
    assert hierarchy(parts=(SimpleNamespace(comm=None),)).graph_reason() is None


@pytest.mark.parametrize("hook", [phases.finite_check, phases.PhaseRecorder(torch.device("cpu"))])
def test_a_phase_hook_selects_eager(hook):
    assert hierarchy(hook=hook).graph_reason() == "hook"


@pytest.mark.parametrize("part", [
    lambda: hierarchy(parts=(SimpleNamespace(comm=object()),)),   # a rank operator or transfer
    lambda: LocalSmoothingMGHybrid(                                # an LS level over a rank operator
        (ls_level(SimpleNamespace(comm=object())),), (), (), direct(), 0),
], ids=["part0", "part1"])
def test_a_rank_communicator_selects_eager(part):
    assert part().graph_reason() == "sharded"
    # a coarse solve gathered over the ranks (parallel/sharding.GatheredSolve)
    gathered = GatheredSolve(direct(), SimpleNamespace(comm=object()))
    assert gathered.graph_reason() == "sharded"


def cg_coarse():
    return CGCoarseSolver(op=None, preconditioner=None, maxiter=10, abstol=0.0, reltol=1e-4,
                          use_op_dot=False)


@pytest.mark.parametrize("coarse,reason", [
    (direct(), None),
    (SlottedSolver(direct(), torch.arange(3), torch.arange(3)), None),
    (cg_coarse(), "coarse"),                                       # reads its residual to the host
    (SlottedSolver(cg_coarse(), torch.arange(3), torch.arange(3)), "coarse"),
    (lambda b: b, "coarse"),                                       # does not answer
    (SimpleNamespace(graph_reason=lambda: None), None),            # a sound preconditioner
    (SimpleNamespace(graph_reason=lambda: "hook"), "coarse"),      # one that is not
])
def test_a_coarse_solve_that_may_read_back_selects_eager(coarse, reason):
    assert hierarchy(coarse).graph_reason() == reason


def test_a_reason_builds_no_graph_and_counts_each_application(counts):
    like = SimpleNamespace(device=CUDA, shape=(4,))
    state = vg.VCycleGraph.prepare("hook", pytest.fail, like, torch.float32, torch.float64)
    assert state.reason == "hook" and state.graph is None and state.buf is None
    assert not state.takes(torch.zeros(4, dtype=torch.float64))
    assert not state.takes(torch.zeros(4, dtype=torch.float64))
    assert counts.eager == {"hook": 2} and counts.captures == counts.replays == 0


def test_off_cuda_there_is_no_graph_and_no_count(counts):
    for like in (torch.zeros(4), None):
        assert vg.VCycleGraph.prepare(None, pytest.fail, like, torch.float32, torch.float64) is None
    assert counts.summary() == {"captures": 0, "replays": 0, "eager": {}, "capture_s": 0.0}


class DoublingGraph:
    """Stand-in for a captured graph: each replay doubles the static vector."""

    def __init__(self, buf):
        self.buf, self.replays = buf, 0

    def replay(self):
        self.buf.mul_(2)
        self.replays += 1


def replaying(outer=torch.float64, level=torch.float32, n=5, calls=None):
    buf = torch.zeros(n, dtype=level)
    return vg.VCycleGraph(None, outer, buf, DoublingGraph(buf), calls or {})


def test_the_stream_already_capturing_selects_eager(counts, monkeypatch):
    state = replaying()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert not state.takes(torch.ones(5, dtype=torch.float64))
    assert counts.eager == {"capturing": 1} and state.graph.replays == 0


@pytest.mark.parametrize("b", [
    torch.ones(4, dtype=torch.float64),                            # shape
    torch.ones(5, dtype=torch.float32),                            # dtype
    torch.ones(5, dtype=torch.float64, device="meta"),             # device
    torch.nn.Parameter(torch.ones(5, dtype=torch.float64)),        # a tensor subclass
    (torch.ones(5), torch.zeros(5)),                               # a twofloat pair
])
def test_an_input_unlike_the_captured_one_selects_eager(counts, b):
    assert not replaying().takes(b)
    assert counts.eager == {"input": 1}


def test_a_replay_casts_in_and_returns_a_fresh_output(counts):
    state = replaying(calls={"patch_stencil": {torch.float32: 3},
                             "chebyshev_step": {torch.float32: 5}})
    before = kernels.counts()
    b = torch.tensor([1.0, 2.0, 3.0, 1.0 + 2.0**-30, -0.5], dtype=torch.float64)
    assert state.takes(b)
    z1 = state.replay(b)
    assert z1.dtype == torch.float64
    assert torch.equal(z1, 2 * b.to(torch.float32).to(torch.float64))
    kept = z1.clone()
    state.replay(3 * b)
    state.replay(5 * b)
    assert torch.equal(z1, kept)                                   # FirstApply's kept output
    assert counts.replays == 3 and not counts.eager
    # each replay launches what its capture recorded
    added = {name: {k: n - before.get(name, {}).get(k, 0) for k, n in c.items()}
             for name, c in kernels.counts().items()}
    assert added == {"patch_stencil": {torch.float32: 9}, "chebyshev_step": {torch.float32: 15}}


def test_a_capture_takes_its_calls_off_the_counters():
    """A capture launches nothing: its calls come off the counters, and
    ``RECORDED`` keeps them (each capture's warm-up launched as many)."""
    stencil = kernels.counter("patch_stencil")
    before, recorded = kernels.counts(), kernels.counts(kernels.RECORDED)
    with kernels.recorded() as calls:
        for dtype in (torch.float32, torch.float32, torch.float64):
            stencil.add(dtype)
    assert calls == {"patch_stencil": {torch.float32: 2, torch.float64: 1}}
    assert kernels.counts() == before
    was = recorded.get("patch_stencil", {})
    assert kernels.counts(kernels.RECORDED)["patch_stencil"] == {
        k: was.get(k, 0) + n for k, n in calls["patch_stencil"].items()}


def test_equal_dtypes_return_a_clone_of_the_static_vector():
    state = replaying(outer=torch.float32)
    z = state.replay(torch.ones(5))
    assert torch.equal(z, torch.full((5,), 2.0))
    assert z.data_ptr() != state.buf.data_ptr()


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


@pytest.fixture(scope="module", params=["HMG-global", "HMG-local"])
def solved(request):
    prm = small(request.param)
    res, _problem, levels = api.run(prm, "cpu")
    fine = levels[-1]
    if res.mg is not None:
        precond = PreconditionMG(res.mg, torch.float64)
    else:
        precond = api.PreconditionLS(res.ls_mg, fine.op.constrained_keep, torch.float64)
    outer_op, _rhs, _ = api._outer_problem(prm, fine, torch.device("cpu"))
    return res, fine, outer_op, precond


def test_an_instrumented_copy_neither_shares_nor_inherits_the_graph(solved):
    precond = solved[-1]
    cls = type(precond)
    fld = {f.name: f for f in dataclasses.fields(cls)}["graph"]
    assert not fld.init and not fld.compare and not fld.repr
    sentinel = vg.VCycleGraph(None, torch.float64)
    original = dataclasses.replace(precond)
    object.__setattr__(original, "graph", sentinel)
    copy = phases.instrument(original, phases.PhaseRecorder(torch.device("cpu")))
    assert copy.graph is None and original.graph is sentinel      # decided anew: on the CPU, none
    assert copy.graph_reason() == "hook" and precond.graph_reason() is None


def test_cpu_solves_are_the_eager_v_cycle(solved, counts):
    res, fine, outer_op, precond = solved
    assert precond.graph is None
    if isinstance(precond, PreconditionMG):
        level = precond.mg.operators[-1].dtype

        def eager(b):
            return precond.mg.vmult(b.to(level)).to(torch.float64)
    else:
        def eager(b):
            return (precond.lsmg.vmult(b.to(precond.keep.dtype)) * precond.keep).to(torch.float64)

    b = res.rhs_used
    assert torch.equal(precond.vmult(b), eager(b))
    ctrl = small("HMG-global").mg_data.cg_normal
    got, want = (
        cg_solve(outer_op.vmult, b, preconditioner=pre, maxiter=ctrl.maxiter,
                 abstol=ctrl.abstol, reltol=ctrl.reltol, dot=outer_op.dot)
        for pre in (precond.vmult, eager)
    )
    assert got.n_iterations == want.n_iterations == res.n_iterations
    assert torch.equal(got.x, want.x) and torch.equal(fine.to_global(got.x), res.x)
    assert counts.summary() == {"captures": 0, "replays": 0, "eager": {}, "capture_s": 0.0}
