"""Local-smoothing solves domain-decomposed over 4 gloo ranks on the CPU.

One spawn of 4 ranks runs both cases (``parallel.sharding.run_cases``): each
level mesh gets its own Morton-block device-major partition or is replicated
below the granularity threshold, so the copy maps, the edge matrices and
the transfers cross the partitions of two different meshes.

  * HMG-local quadrant r=4 p=2 double (JAX's
    ``test_sharded_ls_matches_single_device``): the one-rank count, x within
    1e-12 of the port's one-rank solve and 1e-8 of the JAX package's;
  * HPMG-local r=3 p=2 double: the one-rank count, x within 1e-12;
  * after an LS V-cycle, the coarsest level's vector bit for bit equal on
    every rank.
"""

import time

import numpy as np
import pytest

from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.parallel.launch import launch
from dealii_multigrid_tpu_torch.utils.params import RunParameters as TParams
from test_torch_sharded_solve import TARGET, WORLD, params, rel

CASES = {
    "hmg-local": params(TParams, "HMG-local", 4, 2),
    "hpmg-local": params(TParams, "HPMG-local", 3, 2),
}


@pytest.fixture(scope="module")
def sharded():
    cases = [{"params": prm, "coarse_probe": True} for prm in CASES.values()]
    t0 = time.perf_counter()
    out = launch(TARGET, cases, WORLD, "cpu", timeout=600)
    print(f"{WORLD} ranks: {time.perf_counter() - t0:.1f} s")
    return dict(zip(CASES, out))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ls_solve_matches_one_rank(sharded, name):
    ref, _, _ = tapi.run(CASES[name], "cpu")
    got = sharded[name]
    assert got["converged"] and got["n_shards"] == WORLD
    assert got["true_residual"] <= got["guard_threshold"]
    assert got["n_iterations"] == ref.n_iterations
    r = rel(got["x"], ref.x.numpy())
    print(f"{name}: {got['n_iterations']} iterations, x vs one rank {r:.3e}, "
          f"sub_comm_size {got['sub_comm_size']}, "
          f"{sum(p is not None for p in got['partitions'])} of {len(got['partitions'])} "
          "level meshes sharded")
    assert r <= 1e-12, r
    # the partitions applied per level mesh (None: replicated)
    assert any(p is not None for p in got["partitions"])
    assert got["partitions"][0] is None and got["sub_comm_size"] == 1


def test_sharded_hmg_local_matches_jax(sharded):
    from dealii_multigrid_tpu import api as japi
    from dealii_multigrid_tpu.mesh import generators as JG
    from dealii_multigrid_tpu.utils.params import RunParameters as JParams

    jres, _, _ = japi.solve_with_local_smoothing_hybrid(
        params(JParams, "HMG-local", 4, 2), JG.create("quadrant", 3, 4, 0)
    )
    got = sharded["hmg-local"]
    assert got["n_iterations"] == int(jres.n_iterations)
    assert rel(got["x"], np.asarray(jres.x)) <= 1e-8


@pytest.mark.parametrize("name", list(CASES))
def test_ls_coarse_vector_bit_equal_across_ranks(sharded, name):
    assert sharded[name]["coarse_equal"] is True
