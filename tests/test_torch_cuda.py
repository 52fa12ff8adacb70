"""Tests that need a CUDA card; each skips with a reason where there is none.

Run them on the card with:  python -m pytest --noconftest tests/test_torch_cuda.py -q
They build the patch-stencil kernel from csrc/ at first use (nvcc, sm_90a).
Tolerances: float32 rtol 2e-5 and atol 2e-4 * max|ref| (sums in another
order than the plain version's tensordot chain); float64 1e-12 * max|ref|.
"""

import numpy as np
import pytest
import torch

from dealii_multigrid_tpu_torch import api
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps, tensor
from dealii_multigrid_tpu_torch.ops.hybrid_format import _assembled_1d
from dealii_multigrid_tpu_torch.utils.params import RunParameters

#: (NP, S) of the patch levels L7..L2 of quadrant r=7 p=4 (chip_smoke.py)
MAIN_PATH_SHAPES = [(512, 33), (64, 33), (8, 33), (8, 17), (27, 9), (8, 9)]
DTYPES = [torch.float32, torch.float64]

pytestmark = pytest.mark.cuda


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


def assert_matches_plain(got, args, dtype):
    ref = ps.patch_stencil_reference(*args)
    rmax = float(ref.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-4 * rmax)
    else:
        assert float((got - ref).abs().max()) <= 1e-12 * rmax


@pytest.mark.parametrize("S", [9, 17, 33])
@pytest.mark.parametrize("NP", [1, 8, 512])
def test_kernel_matches_plain_version_float32(cuda, S, NP):
    args = stencil_inputs(S, NP, torch.float32, cuda)
    before = ps.launches.count
    got = ps.patch_stencil(*args, 4)
    torch.cuda.synchronize()
    assert ps.launches.count == before + 1
    assert_matches_plain(got, args, torch.float32)


@pytest.mark.parametrize("S", [9, 17, 33])
def test_kernel_matches_plain_version_float64(cuda, S):
    args = stencil_inputs(S, 64, torch.float64, cuda)
    assert_matches_plain(ps.patch_stencil(*args, 4), args, torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("NP,S", MAIN_PATH_SHAPES)
def test_kernel_at_main_path_shapes(cuda, NP, S, dtype):
    args = stencil_inputs(S, NP, dtype, cuda)
    assert_matches_plain(ps.patch_stencil(*args, 4), args, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_kernel_each_degree(cuda, p, dtype):
    """band = p at S = 8p + 1 (p = 8 is S = 65: several y-tiles a plane)."""
    args = stencil_inputs(8 * p + 1, 5, dtype, cuda, p=p)
    assert_matches_plain(ps.patch_stencil(*args, p), args, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 2, 3, 5, 7])
def test_kernel_random_banded_matrices(cuda, b, dtype):
    """Random KS, MS zero outside band b, not the assembled structure."""
    S, NP = 33, 8
    rng = np.random.default_rng(100 + b)
    i, j = np.indices((S, S))
    KS, MS = (np.where(abs(i - j) <= b, rng.standard_normal((S, S)), 0.0) for _ in range(2))
    arrs = (rng.standard_normal((NP, S**3)), KS, MS, rng.uniform(0.5, 2.0, NP))
    args = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in arrs]
    assert ps.matrix_band(KS, MS) == b
    assert_matches_plain(ps.patch_stencil(*args, b), args, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("NP,S,p", [(512, 17, 2), (512, 9, 1)])
def test_kernel_at_hpmg_fine_mesh_shapes(cuda, NP, S, p, dtype):
    """The p = 2 and p = 1 levels of HPMG on the r=7 fine mesh."""
    args = stencil_inputs(S, NP, dtype, cuda, p=p)
    assert ps.matrix_band(args[1].cpu(), args[2].cpu()) == p
    assert_matches_plain(ps.patch_stencil(*args, p), args, dtype)


def test_kernel_allocates_only_out(cuda):
    args = stencil_inputs(33, 64, torch.float32, cuda)
    ps.patch_stencil(*args, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = ps.patch_stencil(*args, 4)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= out.numel() * out.element_size() + 512


def small_params(mg_type, r, p, number, mg_number):
    prm = RunParameters()
    prm.type = mg_type
    prm.geometry_type = "quadrant"
    prm.n_ref_global = r
    prm.fe_degree_fine = p
    prm.number_type = number
    prm.mg_number_type = mg_number
    prm.mg_data.smoother.degree = 3
    prm.mg_data.n_repetitions = 1
    return prm


@pytest.mark.parametrize("mg_type,r,p,number,mg_number,tol", [
    ("HMG-global", 4, 4, "double", "double", 1e-8),
    ("PMG", 3, 4, "double", "double", 1e-8),
    ("HPMG", 3, 4, "double", "double", 1e-8),
    ("HMG-global", 3, 2, "mixed", "float", 1e-5),
    ("HMG-global", 3, 2, "df32", "float", 1e-5),
    ("HPMG", 3, 2, "mixed", "float", 1e-5),
    ("HPMG", 3, 2, "df32", "float", 1e-5),
    ("HMG-local", 3, 4, "double", "double", 1e-8),
    ("HPMG-local", 3, 4, "double", "double", 1e-8),
    ("HMG-local", 3, 2, "mixed", "float", 1e-5),
    ("HMG-local", 3, 2, "df32", "float", 1e-5),
    ("HPMG-local", 3, 2, "mixed", "float", 1e-5),
    ("HPMG-local", 3, 2, "df32", "float", 1e-5),
])
def test_small_solve_on_card_matches_cpu(cuda, mg_type, r, p, number, mg_number, tol):
    prm = small_params(mg_type, r, p, number, mg_number)
    before = ps.launches.count
    res_gpu, _, levels = api.run(prm, cuda)
    assert ps.launches.count > before
    assert all(lv.op.band == lv.degree for lv in levels)
    res_cpu, _, _ = api.run(prm, "cpu")
    assert res_gpu.n_iterations == res_cpu.n_iterations
    assert res_gpu.x.dtype == res_cpu.x.dtype
    rel = (res_gpu.x.cpu() - res_cpu.x).abs().max() / res_cpu.x.abs().max()
    assert float(rel) <= tol
