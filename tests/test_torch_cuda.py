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
from dealii_multigrid_tpu_torch.models import poisson
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps, tensor
from dealii_multigrid_tpu_torch.ops.hybrid_format import _assembled_1d, cell_slot_table
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


# --- algebraic multigrid, the coarse-solver types, the CLI and phase timers ---


def amg_matrix():
    from dealii_multigrid_tpu_torch.mesh import dof, generators
    from dealii_multigrid_tpu_torch.solvers.coarse import assemble_sparse_matrix

    dofh = dof.distribute_dofs(generators.create("quadrant", 3, 4), 1)
    return assemble_sparse_matrix(dofh, dof.make_hanging_node_constraints(dofh))


@pytest.mark.parametrize("flavor", ["sa", "boomer"])
@pytest.mark.parametrize("n_cycles", [1, 2])
def test_amg_apply_on_card_matches_cpu(cuda, flavor, n_cycles):
    from dealii_multigrid_tpu_torch.solvers import amg

    build = amg.build_amg if flavor == "sa" else amg.build_amg_boomer
    A = amg_matrix()
    on_card = build(A, torch.float64, cuda, coarse_size=100, n_cycles=n_cycles)
    on_cpu = build(A, torch.float64, "cpu", coarse_size=100, n_cycles=n_cycles)
    assert len(on_card.levels) == len(on_cpu.levels) >= 2
    b = torch.as_tensor(np.random.default_rng(11).standard_normal(A.shape[0]))
    want = on_cpu.vmult(b)
    got = on_card.vmult(b.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    P = on_card.levels[1].P
    r = P.rmatvec(b.to(cuda)).cpu()
    assert float((r - on_cpu.levels[1].P.rmatvec(b)).abs().max()) <= 1e-10 * float(r.abs().max())


def test_float32_amg_apply_is_repeatable_on_card(cuda):
    """Restriction gathers through the transposed table: two applications of
    one float32 hierarchy agree bit for bit."""
    from dealii_multigrid_tpu_torch.solvers import amg

    pre = amg.build_amg(amg_matrix(), torch.float32, cuda, coarse_size=100)
    b = torch.as_tensor(
        np.random.default_rng(12).standard_normal(pre.levels[0].A.shape[0]),
        dtype=torch.float32, device=cuda,
    )
    first = pre.vmult(b)
    assert all(torch.equal(pre.vmult(b), first) for _ in range(5))


@pytest.mark.parametrize("mg_type,r,p,coarse,n_cycles,min_level", [
    ("HPMG", 4, 2, "amg", 1, 5),
    ("HPMG", 4, 2, "amg_petsc", 2, 5),
    ("HPMG", 4, 2, "cg_with_amg", 1, 5),
    ("HPMG", 4, 2, "cg", 1, 5),
    ("HPMG", 4, 2, "cg_with_chebyshev", 1, 5),
    ("HMG-local", 3, 4, "amg", 1, 2),
    ("AMG", 4, 2, "amg", 1, -1),
    ("AMGPETSc", 4, 2, "amg", 1, -1),
])
def test_amg_solves_on_card_match_cpu(cuda, monkeypatch, mg_type, r, p, coarse, n_cycles,
                                      min_level):
    """The direct-solve limit is lowered so that the coarse solve is AMG."""
    from dealii_multigrid_tpu_torch.solvers import coarse as coarse_mod

    monkeypatch.setattr(coarse_mod, "DIRECT_SOLVER_MAX_DOFS", 300)
    prm = small_params(mg_type, r, p, "double", "double")
    prm.min_level = min_level
    prm.mg_data.coarse_solver.type = coarse
    prm.mg_data.coarse_solver.n_cycles = n_cycles
    res_gpu, _, _ = api.run(prm, cuda)
    res_cpu, _, _ = api.run(prm, "cpu")
    assert res_gpu.converged and res_gpu.n_iterations == res_cpu.n_iterations
    assert res_gpu.solve_iterations == [res_gpu.n_iterations] * 2
    rel = (res_gpu.x.cpu() - res_cpu.x).abs().max() / res_cpu.x.abs().max()
    assert float(rel) <= 1e-8


def test_cli_and_phase_timers_on_card(cuda, tmp_path, capsys):
    import json

    from dealii_multigrid_tpu_torch import cli

    path = tmp_path / "input.json"
    path.write_text(json.dumps({
        "Type": "HMG-local", "GeometryType": "quadrant", "NRefGlobal": 3, "Degree": 2,
        "SmootherDegree": 3, "MGNumberType": "float", "NumberType": "double",
        "NRepetitions": 1, "ProfilePhases": True,
    }))
    assert cli.main([str(path)]) == 0                # no --device: the card
    out = capsys.readouterr().out
    assert out.startswith("device: cuda:0 (")
    header = [ln for ln in out.splitlines() if ln.startswith("dim ")][-1].split()
    row = out.splitlines()[-1].split()
    cells = dict(zip(header, row))
    for key in ("time_pre", "time_residuum", "time_res", "time_cs", "time_pro",
                "time_edge_pro", "time_post", "time_to_mg", "time_to_global"):
        assert float(cells[key]) > 0.0, key
    assert "MG phases per level" in out
    assert float(cells["time_cg"]) > 0.0             # the instrumented solve's remainder


# --- fixed-order sums, 2D multigrid and Stokes ---


def fixed_order_sites(dev):
    """(name, fn, float32 input) of each fixed-order site at a small size:
    the hybrid operator, the Poisson right-hand side's assembly and h- and
    p-restrictions (3D r=4), the gather operator, the h- and p-restrictions
    of a 2D HPMG hierarchy and the LS restriction of a 2D HMG-local one
    (r=6)."""
    rng = np.random.default_rng(30)
    sites = []
    for mg_type in ("HMG-global", "HPMG"):
        res, _, levels = api.run(small_params(mg_type, 4, 4, "float", "float"), dev)
        fine = levels[-1]
        x = torch.as_tensor(fine.fmt.from_global(rng.standard_normal(fine.dofh.n_dofs)),
                            dtype=torch.float32, device=dev)
        if mg_type == "HMG-global":
            sites.append(("HybridOperator.vmult", fine.op.vmult, x))
            slots = cell_slot_table(fine.fmt)
            sites.append(("Poisson RHS", lambda _, fine=fine, slots=slots: (
                poisson.assemble_problem_hybrid(
                    fine.dofh, fine.hanging, fine.op, slots, fine.fmt, "Gaussian")[1]), x))
        sites.append((f"HybridTransfer.restrict {mg_type}", res.mg.transfers[-1].restrict, x))
    for mg_type in ("HPMG", "HMG-local"):
        prm = small_params(mg_type, 6, 4, "float", "float")
        prm.dim = 2
        res, _, levels = api.run(prm, dev)
        if mg_type == "HPMG":
            op = levels[-1].op
            sites.append(("LaplaceOperator.vmult", op.vmult, torch.as_tensor(
                rng.standard_normal(op.n_dofs), dtype=torch.float32, device=dev)))
            for tr in (res.mg.transfers[-1], res.mg.transfers[2]):
                sites.append(("TwoLevelTransfer.restrict", tr.restrict, torch.as_tensor(
                    rng.standard_normal(tr.n_dofs_fine), dtype=torch.float32, device=dev)))
        else:
            lt = res.ls_mg.transfers[-1]
            sites.append(("LSTransfer.restrict", lt.restrict, torch.as_tensor(
                rng.standard_normal(lt.n_f), dtype=torch.float32, device=dev)))
    return sites


def test_fixed_order_sites_are_bit_repeatable_on_card(cuda):
    """Each fixed-order site, 20 runs of one float32 input: bit-equal."""
    for name, fn, x in fixed_order_sites(cuda):
        ref = fn(x)
        assert all(torch.equal(fn(x), ref) for _ in range(19)), name


@pytest.mark.parametrize("mg_type", ["HMG-global", "PMG", "HPMG", "HMG-local", "HPMG-local"])
def test_2d_solve_on_card_matches_cpu(cuda, mg_type):
    prm = small_params(mg_type, 4, 2, "double", "double")
    prm.dim = 2
    res_gpu, _, _ = api.run(prm, cuda)
    res_cpu, _, _ = api.run(prm, "cpu")
    assert res_gpu.converged and res_gpu.n_iterations == res_cpu.n_iterations
    assert res_gpu.x.is_cuda
    rel = (res_gpu.x.cpu() - res_cpu.x).abs().max() / res_cpu.x.abs().max()
    assert float(rel) <= 1e-8


def test_stokes_on_card_matches_cpu(cuda):
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.models import stokes
    from dealii_multigrid_tpu_torch.solvers.gmres import gmres_solve
    from dealii_multigrid_tpu_torch.utils.params import MultigridParameters

    mg = MultigridParameters()
    mg.smoother.degree = 3
    out = []
    for dev in (cuda, torch.device("cpu")):
        op, block, _ = stokes.build_stokes(generators.create("hypercube", 3, 2, 0), mg, device=dev)
        assert op.B.idx.device.type == dev.type and op.keep_v.device.type == dev.type
        # the record's right-hand side: velocity masked, pressure mean-free
        b = np.random.default_rng(0).normal(size=3 * op.n_v + op.n_p)
        b[: 3 * op.n_v] *= op.keep_v.cpu().numpy()
        b[3 * op.n_v:] -= b[3 * op.n_v:].mean()
        b = torch.as_tensor(b, device=dev)
        g = gmres_solve(op.vmult, b, stokes.triangular_preconditioner(op, block).vmult,
                        m=30, maxiter=200, reltol=1e-8)
        x_m, it_m, _ = stokes.minres_solve(op.vmult, b, block.vmult, maxiter=500, reltol=1e-8)
        out.append((g.x.cpu(), g.n_iterations, x_m.cpu(), it_m))
    (xg, ig, xm, im), (xg_c, ig_c, xm_c, im_c) = out
    assert ig == ig_c and im == im_c
    assert float((xg - xg_c).abs().max()) <= 1e-8 * float(xg_c.abs().max())
    assert float((xm - xm_c).abs().max()) <= 1e-8 * float(xm_c.abs().max())
