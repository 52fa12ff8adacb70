"""Tests that need a CUDA card; each skips with a reason where there is none.

Run them on the card with:  python -m pytest tests/test_torch_cuda.py -q
They build the patch-stencil kernel from csrc/ at first use (nvcc, sm_90a).
"""

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu_torch import api
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps, tensor
from dealii_multigrid_tpu_torch.ops.hybrid_format import _assembled_1d
from dealii_multigrid_tpu_torch.utils.params import RunParameters


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def stencil_inputs(S, NP, dtype, dev, p=4):
    K = (S - 1) // p
    rng = np.random.default_rng(S * 1000 + NP)
    KS = _assembled_1d(tensor.stiffness_matrix_1d(p), K, p)
    MS = _assembled_1d(tensor.mass_matrix_1d(p), K, p)
    arrs = (rng.standard_normal((NP, S**3)), KS, MS, rng.uniform(0.5, 2.0, NP))
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrs]


@pytest.mark.parametrize("S", [9, 17, 33])
@pytest.mark.parametrize("NP", [1, 8, 512])
def test_kernel_matches_plain_version_float32(cuda, S, NP):
    args = stencil_inputs(S, NP, torch.float32, cuda)
    before = ps.launches.count
    got = ps.patch_stencil(*args)
    torch.cuda.synchronize()
    assert ps.launches.count == before + 1
    ref = ps.patch_stencil_reference(*args)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("S", [9, 17, 33])
def test_kernel_matches_plain_version_float64(cuda, S):
    args = stencil_inputs(S, 64, torch.float64, cuda)
    got = ps.patch_stencil(*args)
    ref = ps.patch_stencil_reference(*args)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_small_solve_on_card_matches_cpu(cuda):
    prm = RunParameters()
    prm.type = "HMG-global"
    prm.geometry_type = "quadrant"
    prm.n_ref_global = 4
    prm.fe_degree_fine = 4
    prm.number_type = "double"
    prm.mg_number_type = "double"
    prm.mg_data.smoother.degree = 3
    prm.mg_data.n_repetitions = 1
    before = ps.launches.count
    res_gpu, _, _ = api.run(prm, cuda)
    assert ps.launches.count > before
    res_cpu, _, _ = api.run(prm, "cpu")
    assert res_gpu.n_iterations == res_cpu.n_iterations
    rel = (res_gpu.x.cpu() - res_cpu.x).abs().max() / res_cpu.x.abs().max()
    assert float(rel) <= 1e-8
