"""Global-coarsening solves domain-decomposed over 4 gloo ranks on the CPU.

One spawn of 4 ranks (parallel/launch.py) runs every case of this module
(``parallel.sharding.run_cases``); each case is held to the port's one-rank
solve of the same configuration, and the first two to the JAX package's
single-device solve as well (its own bound, ``tests/test_parallel.py``):

  * HMG-global quadrant r=4 p=3 double, the Morton default partition and
    CellWeightPolicy-2.0: the one-rank count, x within 1e-12 of one rank
    and 1e-8 of JAX;
  * PMG and HPMG float, HMG-global mixed, r=3 p=2: JAX's 1e-5 and +-1
    iteration;
  * df32 and bfloat16 levels under float, r=3 p=2: the one-rank count and x
    within the number type's bound (1e-5, 1e-2);
  * the gather-engine CG at p=1 r=3 over Morton cell blocks (JAX's
    ``test_sharded_cg_matches_single_device``, atol 1e-10);
  * the replicated coarsest level's vector, bit for bit equal on every rank
    after a V-cycle, and float32 solves bit-repeatable.

A second, 2-rank launch has one rank raise inside a V-cycle: the launcher
raises in the parent within its timeout and leaves no process behind.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.parallel.launch import launch
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams

TARGET = "dealii_multigrid_tpu_torch.parallel.sharding:run_cases"
WORLD = 4


def params(cls, mg_type, r, p, number="double", mg_number=None, reltol=1e-10, policy=""):
    prm = cls()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.number_type = number
    prm.mg_number_type = mg_number or number
    prm.mg_data.coarse_solver.type = "amg"
    prm.mg_data.smoother.degree = 3
    prm.mg_data.cg_normal.reltol = reltol
    prm.mg_data.n_repetitions = 1
    if policy:
        prm.policy_name = policy
    return prm


CASES = {
    "hmg-default": params(TParams, "HMG-global", 4, 3),
    "hmg-cellweight": params(TParams, "HMG-global", 4, 3, policy="CellWeightPolicy-2.0"),
    "pmg-float": params(TParams, "PMG", 3, 2, "float", reltol=1e-6),
    "hpmg-float": params(TParams, "HPMG", 3, 2, "float", reltol=1e-6),
    "hmg-mixed": params(TParams, "HMG-global", 3, 2, "mixed", "float", reltol=1e-6),
    "hmg-df32": params(TParams, "HMG-global", 3, 2, "df32", "float", reltol=1e-6),
    "hmg-bf16": params(TParams, "HMG-global", 3, 2, "float", "bfloat16", reltol=1e-4),
}
#: x relative to one rank, and the iteration slack
BOUNDS = {
    "hmg-default": (1e-12, 0), "hmg-cellweight": (1e-12, 0),
    "pmg-float": (1e-5, 1), "hpmg-float": (1e-5, 1), "hmg-mixed": (1e-5, 1),
    "hmg-df32": (1e-5, 0), "hmg-bf16": (1e-2, 0),
}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def sharded():
    cases = [{"params": prm} for prm in CASES.values()]
    cases[0]["coarse_probe"] = True
    cases.append({"params": params(TParams, "HMG-global", 3, 2, "float", reltol=1e-6),
                  "repeat": 2})
    cases.append({"gather_cg": ("quadrant", 3, 1, 0)})
    t0 = time.perf_counter()
    out = launch(TARGET, cases, WORLD, "cpu", timeout=600)
    print(f"{WORLD} ranks: {time.perf_counter() - t0:.1f} s")
    res = dict(zip(CASES, out))
    res["repeat"], res["gather_cg"] = out[-2], out[-1]
    return res


@pytest.fixture(scope="module")
def one_rank():
    return {k: tapi.run(prm, "cpu")[0] for k, prm in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_solve_matches_one_rank(sharded, one_rank, name):
    got, ref = sharded[name], one_rank[name]
    bound, slack = BOUNDS[name]
    assert got["converged"] and got["n_shards"] == WORLD
    assert got["true_residual"] <= got["guard_threshold"]
    assert abs(got["n_iterations"] - ref.n_iterations) <= slack, (got["n_iterations"], ref.n_iterations)
    r = rel(got["x"], ref.x.double().numpy())
    print(f"{name}: {got['n_iterations']} iterations, x vs one rank {r:.3e}")
    assert r <= bound, (name, r)
    assert len(got["ranks"]) == WORLD and [s["rank"] for s in got["ranks"]] == list(range(WORLD))


def test_partitions_and_sub_comm_size(sharded):
    """Every level is sharded or replicated by the granularity rule; the
    partitions applied cover every cell of a sharded level with ranks
    0..3; the coarsest level is replicated (sub_comm_size 1)."""
    got = sharded["hmg-default"]
    assert got["sub_comm_size"] == 1 and got["partitions"][0] is None
    for part, info in zip(got["partitions"], got["ranks"][0]["levels"]):
        assert (part is None) == (info["n_shards"] == 1)
        if part is not None:
            assert set(np.unique(part)) == set(range(WORLD))
    fine = [r["levels"][-1] for r in got["ranks"]]
    assert all(f["ghosts"] < f["owned"] for f in fine)


def test_first_double_cases_match_jax(sharded):
    """HMG-global r=4 p=3 double, both partitions, against the JAX package's
    single-device solve (its bound 1e-8, equal iteration counts)."""
    from dealii_multigrid_tpu import api as japi
    from dealii_multigrid_tpu.mesh import generators as JG
    from dealii_multigrid_tpu.utils.params import RunParameters as JParams

    jprm = params(JParams, "HMG-global", 4, 3)
    jres, _, _ = japi.solve_with_global_coarsening_hybrid(jprm, JG.create("quadrant", 3, 4, 0))
    jx = np.asarray(jres.x, np.float64)
    for name in ("hmg-default", "hmg-cellweight"):
        got = sharded[name]
        assert got["n_iterations"] == int(jres.n_iterations)
        assert rel(got["x"], jx) <= 1e-8, name


def test_replicated_coarse_vector_bit_equal_across_ranks(sharded):
    assert sharded["hmg-default"]["coarse_equal"] is True


def test_float32_sharded_solves_repeat_bit_for_bit(sharded):
    assert sharded["repeat"]["repeat_equal"] is True


def test_sharded_gather_engine_cg_matches_one_device(sharded):
    """CG on the gather-engine Laplacian over Morton cell blocks equals the
    one-device CG (JAX's test_sharded_cg_matches_single_device, p=1 r=3)."""
    from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
    from dealii_multigrid_tpu_torch.ops.operator import make_operator
    from dealii_multigrid_tpu_torch.solvers.cg import cg_solve

    got = sharded["gather_cg"]
    dofh = TD.distribute_dofs(TG.create("quadrant", 3, 3), 1)
    op = make_operator(dofh, TD.make_hanging_node_constraints(dofh), "cpu", torch.float64)
    b = torch.as_tensor(got["b"], dtype=torch.float64)
    ref = cg_solve(op.vmult, b, maxiter=20, reltol=1e-6)
    assert got["n_iterations"] == ref.n_iterations
    assert np.allclose(got["x"], ref.x.numpy(), atol=1e-10)


def test_rank_failure_raises_in_parent_and_leaves_no_process():
    t0 = time.perf_counter()
    case = {"params": params(TParams, "HMG-global", 3, 2, "float", reltol=1e-6), "fault": 1}
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*injected fault"):
        launch(TARGET, [case], 2, "cpu", timeout=120, collective_timeout=60)
    assert time.perf_counter() - t0 < 120
    assert multiprocessing.active_children() == []
