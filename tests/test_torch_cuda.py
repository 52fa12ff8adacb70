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


@pytest.mark.parametrize("coarsening,schur,contrast,seed,tol", [
    ("mean", "mass", 1e2, 1, 1e-8), ("galerkin", "wbfbt", 1e4, 0, 1e-6)])
def test_nsinker_on_card_matches_cpu(cuda, coarsening, schur, contrast, seed, tol):
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.models import nsinker, stokes
    from dealii_multigrid_tpu_torch.solvers.gmres import gmres_solve
    from dealii_multigrid_tpu_torch.utils.params import MultigridParameters

    mg = MultigridParameters()
    mg.smoother.degree = 3
    out = []
    for dev in (cuda, torch.device("cpu")):
        op, block, _ = nsinker.build_stokes_nsinker(
            generators.create("hypercube", 3, 2, 0), mg,
            nsinker.nsinker_viscosity(n_sinkers=4, eta_max=contrast, seed=seed),
            coarsening=coarsening, schur=schur, device=dev)
        assert op.B.idx.device.type == dev.type and op.a_op.scalar.scale.device.type == dev.type
        b = np.random.default_rng(1).normal(size=3 * op.n_v + op.n_p)
        b[: 3 * op.n_v] *= op.keep_v.cpu().numpy()
        b[3 * op.n_v:] -= b[3 * op.n_v:].mean()
        g = gmres_solve(op.vmult, torch.as_tensor(b, device=dev),
                        stokes.triangular_preconditioner(op, block).vmult, m=30, maxiter=150, reltol=1e-8)
        assert g.converged
        out.append((g.x.cpu(), g.n_iterations))
    (x, it), (x_c, it_c) = out
    assert it == it_c
    assert float((x - x_c).abs().max()) <= tol * float(x_c.abs().max())


def test_convection_step_on_card_matches_cpu(cuda):
    from dealii_multigrid_tpu_torch.mantle_convection import demo

    (_, T, hist), (_, T_c, hist_c) = (demo.run_demo(r=2, n_steps=2, device=d) for d in (cuda, "cpu"))
    assert T.is_cuda
    assert [h["iterations"] for h in hist] == [h["iterations"] for h in hist_c]
    assert float((T.cpu() - T_c).abs().max()) <= 1e-10


# --- bfloat16 levels and the bfloat16 instance of the kernel ---


@pytest.mark.parametrize("NP,S", MAIN_PATH_SHAPES)
def test_bf16_kernel_is_one_rounding_of_float64(cuda, NP, S):
    """The bfloat16 instance computes in float32 and rounds once: within
    2^-8 |ref| + 1e-5 max|ref| of a float64 stencil of its own bfloat16
    inputs, and within 2e-2 of max of the plain bfloat16 chain."""
    args = [t.to(torch.bfloat16) for t in stencil_inputs(S, NP, torch.float32, cuda)]
    before = dict(ps.launches.per_dtype)
    got = ps.patch_stencil(*args, 4)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert ps.launches.per_dtype[torch.bfloat16] == before.get(torch.bfloat16, 0) + 1
    ref64 = ps.patch_stencil_reference(*(t.double() for t in args))
    err = (got.double() - ref64).abs()
    assert bool(torch.all(err <= 2.0**-8 * ref64.abs() + 1e-5 * ref64.abs().max()))
    plain = ps.patch_stencil_reference(*args).double()
    assert float((got.double() - plain).abs().max()) <= 2e-2 * float(plain.abs().max())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("S", [3, 4, 5, 8, 9, 17, 33, 65])
def test_bf16_kernel_is_the_f32_kernel_rounded_once(cuda, S, offset):
    """The bfloat16 instance does the float32 instance's arithmetic and
    rounds once: on a view that starts at element 0 or 1 of a larger buffer
    (rows at either 4-byte alignment), for every band below S up to 8, it
    equals bit for bit the f32 kernel on the same values widened to float32
    and rounded once to bfloat16; with NaN, +Inf and -Inf in u it equals it
    NaN for NaN and value for value elsewhere.  Without them it also holds
    chip_smoke.py phase x's constants (2^-8 |ref| + 1e-5 max|ref| of a
    float64 stencil of its bfloat16 inputs, 2e-2 of max of the plain
    bfloat16 chain)."""
    NP = 8 if S < 65 else 3
    rng = np.random.default_rng(1000 * S + offset)
    i, j = np.indices((S, S))
    for band in range(1, min(S - 1, 8) + 1):
        KS, MS = (torch.as_tensor(np.where(abs(i - j) <= band, rng.standard_normal((S, S)), 0.0),
                                  dtype=torch.bfloat16, device=cuda) for _ in range(2))
        sc = torch.as_tensor(rng.uniform(0.5, 2.0, NP), dtype=torch.bfloat16, device=cuda)
        buf = torch.zeros(NP * S**3 + 2, dtype=torch.bfloat16, device=cuda)
        xp = buf[offset:offset + NP * S**3].view(NP, S**3)
        for special in (False, True):
            xp.copy_(torch.as_tensor(rng.standard_normal((NP, S**3)), dtype=torch.bfloat16))
            if special:
                flat = xp.view(-1)
                for k, v in enumerate((float("nan"), float("inf"), -float("inf"))):
                    flat[(k + 1) * flat.numel() // 5] = v
            got = ps.patch_stencil(xp, KS, MS, sc, band)
            want = ps.patch_stencil(*(t.float() for t in (xp, KS, MS, sc)), band).to(torch.bfloat16)
            nan = torch.isnan(want)
            assert torch.equal(torch.isnan(got), nan), (S, band, offset, special)
            assert torch.equal(got[~nan], want[~nan]), (S, band, offset, special)
            if special:
                assert 0 < int(nan.sum()) < nan.numel()
                continue
            ref64 = ps.patch_stencil_reference(*(t.double() for t in (xp, KS, MS, sc)))
            err = (got.double() - ref64).abs()
            assert bool(torch.all(err <= 2.0**-8 * ref64.abs() + 1e-5 * ref64.abs().max()))
            plain = ps.patch_stencil_reference(xp, KS, MS, sc).double()
            assert float((got.double() - plain).abs().max()) <= 2e-2 * float(plain.abs().max())


@pytest.mark.parametrize("mg_type,number", [
    ("HMG-global", "float"), ("HMG-global", "double"), ("HPMG", "double"), ("HMG-local", "double"),
])
def test_bf16_solve_on_card_matches_cpu(cuda, monkeypatch, mg_type, number):
    """The card's bfloat16 stencil rounds once, so it is held to the CPU run
    whose stencil rounds once: HMG-local takes 4 there and on the card (and
    in the JAX package so rounded, tests/test_torch_bf16_solve.py), 5 with
    the CPU's plain chain."""
    plain = ps.patch_stencil_reference

    def rounded_once(xp, KS, MS, pscale):
        if xp.dtype != torch.bfloat16:
            return plain(xp, KS, MS, pscale)
        return plain(*(t.double() for t in (xp, KS, MS, pscale))).to(torch.bfloat16)

    prm = small_params(mg_type, 3, 4, number, "bfloat16")
    res_gpu, _, levels = api.run(prm, cuda)
    monkeypatch.setattr(ps, "patch_stencil_reference", rounded_once)
    res_cpu, _, _ = api.run(prm, "cpu")
    assert levels[-1].op.dtype == torch.bfloat16
    assert res_gpu.converged and res_gpu.n_iterations == res_cpu.n_iterations
    rel = (res_gpu.x.cpu().double() - res_cpu.x.double()).norm() / res_cpu.x.double().norm()
    assert float(rel) <= 1e-5


# --- the preconditioners' CUDA graphs (solvers/vcycle_graph.py) ---


@pytest.fixture(scope="module", params=["HMG-global", "HMG-local"])
def graphed(request):
    """(preconditioner built on the card, its eager application, the outer
    operator, the right-hand side, the graph counts since the build) at
    quadrant r=4 p=4, double over float levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG
    from dealii_multigrid_tpu_torch.utils.phases import GRAPHS

    dev = torch.device("cuda:0")
    prm = small_params(request.param, 4, 4, "double", "float")
    res, _, levels = api.run(prm, dev)
    fine = levels[-1]
    outer_op, rhs, _ = api._outer_problem(prm, fine, dev)
    GRAPHS.reset()
    if res.mg is not None:
        precond = PreconditionMG(res.mg, torch.float64)

        def eager(b):
            return res.mg.vmult(b.to(torch.float32)).to(torch.float64)
    else:
        precond = api.PreconditionLS(res.ls_mg, fine.op.constrained_keep, torch.float64)

        def eager(b):
            return (res.ls_mg.vmult(b.to(torch.float32)) * precond.keep).to(torch.float64)
    torch.cuda.synchronize()
    return precond, eager, outer_op, rhs, GRAPHS.summary()


def test_replay_equals_the_eager_application_bit_for_bit(graphed):
    precond, eager, _op, rhs, graphs = graphed
    assert precond.graph is not None and precond.graph.reason is None
    gen = torch.Generator().manual_seed(16)
    for _ in range(3):
        b = torch.randn(rhs.shape, generator=gen, dtype=torch.float64).to(rhs.device)
        assert torch.equal(precond.vmult(b), eager(b))


def test_a_kept_output_survives_later_applications(graphed):
    precond, _eager, _op, rhs, _graphs = graphed
    z = precond.vmult(rhs)
    kept = z.clone()
    precond.vmult(2.0 * rhs)
    precond.vmult(-rhs)
    assert torch.equal(z, kept)


def test_cg_with_replays_equals_cg_with_the_eager_v_cycle(graphed):
    from dealii_multigrid_tpu_torch.solvers.cg import cg_solve

    precond, eager, op, rhs, _graphs = graphed
    got, want = (cg_solve(op.vmult, rhs, preconditioner=pre, reltol=1e-4, dot=op.dot)
                 for pre in (precond.vmult, eager))
    assert got.converged and got.n_iterations == want.n_iterations
    assert torch.equal(got.x, want.x)


def test_one_capture_and_one_replay_per_application(graphed):
    from dealii_multigrid_tpu_torch.utils.phases import GRAPHS

    precond, _eager, _op, rhs, built = graphed
    assert built["captures"] == 1 and built["replays"] == 0 and built["eager"] == {}
    before = GRAPHS.summary()
    for _ in range(4):
        precond.vmult(rhs)
    after = GRAPHS.summary()
    assert after["replays"] == before["replays"] + 4 and after["eager"] == before["eager"]
    assert after["captures"] == before["captures"]


def test_pmg_with_an_amg_coarse_solve_is_captured_and_replays_bit_for_bit(cuda, monkeypatch):
    """PMG at quadrant r=4 p=2 with the AMG on its Q1 level (1,008 DoFs; the
    direct limit and the AMG's coarse size lowered to 100, so the AMG has
    levels above its dense coarsest): the whole application, the AMG's ELL
    gathers and triangular solves included, is one graph, and its replays
    equal the eager application bit for bit."""
    import functools

    from dealii_multigrid_tpu_torch.solvers import amg, coarse
    from dealii_multigrid_tpu_torch.solvers.multigrid import PreconditionMG
    from dealii_multigrid_tpu_torch.utils.phases import GRAPHS

    monkeypatch.setattr(coarse, "DIRECT_SOLVER_MAX_DOFS", 100)
    monkeypatch.setattr(coarse, "build_amg", functools.partial(amg.build_amg, coarse_size=100))
    prm = small_params("PMG", 4, 2, "double", "float")
    prm.mg_data.coarse_solver.n_cycles = 2
    res, _, levels = api.run(prm, cuda)
    found = res.mg.coarse_solve.inner          # the AMG in its slot wrapper
    assert isinstance(found, amg.AMGPreconditioner) and len(found.levels) >= 2
    _op, rhs, _ = api._outer_problem(prm, levels[-1], cuda)
    GRAPHS.reset()
    precond = PreconditionMG(res.mg, torch.float64)
    assert precond.graph is not None and precond.graph.reason is None
    assert GRAPHS.summary()["captures"] == 1
    gen = torch.Generator().manual_seed(17)
    for _ in range(3):
        b = torch.randn(rhs.shape, generator=gen, dtype=torch.float64).to(cuda)
        assert torch.equal(precond.vmult(b), res.mg.vmult(b.to(torch.float32)).to(torch.float64))
    after = GRAPHS.summary()
    assert after["replays"] == 3 and after["eager"] == {}


# --- one kernel per Chebyshev step (ops/chebyshev_step.py) ---

#: slots of the finest level of hypercube r=6 p=4 (512 patches of 33^3)
FINEST_SLOTS = 512 * 33**3


def step_inputs(n, dtype, dev, offset=0):
    """(ar, keep, x, d, b, inv_diag) of n slots; ``offset`` > 0 makes each
    a view that starts ``offset`` values into its storage (not 16-byte
    aligned)."""
    gen = torch.Generator(device=dev).manual_seed(n + offset)

    def vec(draw):
        return draw(n + offset)[offset:]

    ar, x, d, b = (vec(lambda m: torch.randn(m, generator=gen, dtype=dtype, device=dev))
                   for _ in range(4))
    keep = vec(lambda m: (torch.rand(m, generator=gen, device=dev) < 0.8).to(dtype))
    inv = vec(lambda m: torch.rand(m, generator=gen, dtype=dtype, device=dev) + 0.5)
    return ar, keep, x, d, b, inv


def step_scalars(dtype):
    """(c_d, c_r) of a recurrence step and theta, as the smoother computes them."""
    from dealii_multigrid_tpu_torch.solvers.chebyshev import ChebyshevSmoother

    sm = ChebyshevSmoother.create(None, None, max_eigenvalue=2.6, degree=3)
    theta, delta, sigma = sm._scalars(dtype)
    rho_old = 1.0 / sigma
    rho = 1.0 / (2.0 * sigma - rho_old)
    return rho * rho_old, 2.0 * rho / delta, float(theta)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,offset", [(FINEST_SLOTS, 0), (1001, 0), (1001, 1)])
@pytest.mark.parametrize("step", ["recurrence", "recurrence_x_is_d", "first"])
def test_chebyshev_step_kernel_is_the_eager_chain_bit_for_bit(cuda, step, n, offset, dtype):
    from dealii_multigrid_tpu_torch.ops import chebyshev_step as cs

    ar, keep, x, d, b, inv = step_inputs(n, dtype, cuda, offset)
    c_d, c_r, theta = step_scalars(dtype)
    ax = cs.blend(ar, keep, x)
    before = cs.launches.count
    if step == "first":
        got = cs.first_step(ar, keep, x, b, inv, theta)
        want = cs.first_reference(ax, x, b, inv, theta)
    else:
        d = x if step == "recurrence_x_is_d" else d
        got = cs.recurrence_step(ar, keep, x, d, b, inv, c_d, c_r)
        want = cs.recurrence_reference(ax, x, d, b, inv, c_d, c_r)
    torch.cuda.synchronize()
    assert cs.launches.count == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_smoother_with_the_step_kernel_is_the_eager_chain_on_a_hanging_level(cuda, monkeypatch,
                                                                             dtype):
    """HMG-global quadrant r=3 p=4 (structured hanging faces): the smoother's
    vmult and step with the kernel equal its eager chain bit for bit."""
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.ops import chebyshev_step as cs
    from dealii_multigrid_tpu_torch.solvers import chebyshev

    lv = api.build_level_hybrid(generators.create("quadrant", 3, 3), 4, cuda, dtype)
    assert lv.op.sf_levels
    sm = chebyshev.ChebyshevSmoother.create(lv.op, lv.inv_diag, max_eigenvalue=2.6, degree=3)
    gen = torch.Generator(device=cuda).manual_seed(18)
    x, b = (torch.randn(lv.op.n_slots, generator=gen, dtype=dtype, device=cuda) for _ in range(2))
    before = cs.launches.count
    got = (sm.vmult(b), sm.step(x, b))
    torch.cuda.synchronize()
    assert cs.launches.count == before + 5
    monkeypatch.setattr(chebyshev, "takes_kernel", lambda op, v: False)
    want = (sm.vmult(b), sm.step(x, b))
    assert cs.launches.count == before + 5
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def smoothers_of(precond):
    return (precond.mg if hasattr(precond, "mg") else precond.lsmg).smoothers[1:]


def test_replay_with_the_step_kernel_equals_the_eager_chain(graphed, monkeypatch):
    """The captured application holds the step kernel, and each replay
    counts its launches; its replays equal the eager application without
    the kernel bit for bit."""
    from dealii_multigrid_tpu_torch.ops import chebyshev_step as cs
    from dealii_multigrid_tpu_torch.solvers import chebyshev

    precond, eager, _op, rhs, _graphs = graphed
    calls = precond.graph.calls["chebyshev_step"]
    assert sum(calls.values()) > 0
    gen = torch.Generator().manual_seed(19)
    bs = [torch.randn(rhs.shape, generator=gen, dtype=torch.float64).to(rhs.device)
          for _ in range(2)]
    before = dict(cs.launches.per_dtype)
    got = [precond.vmult(b) for b in bs]
    assert all(cs.launches.per_dtype[k] - before.get(k, 0) == 2 * n for k, n in calls.items())
    monkeypatch.setattr(chebyshev, "takes_kernel", lambda op, v: False)
    before = cs.launches.count
    for g, b in zip(got, bs):
        assert torch.equal(g, eager(b))
    assert cs.launches.count == before


def test_five_step_launches_per_smoothed_level_per_eager_v_cycle(graphed):
    from dealii_multigrid_tpu_torch.ops import chebyshev_step as cs

    precond, eager, _op, rhs, _graphs = graphed
    smoothers = smoothers_of(precond)
    assert all(sm.degree == 3 for sm in smoothers)
    before = cs.launches.count
    eager(rhs)
    torch.cuda.synchronize()
    assert cs.launches.count - before == 5 * len(smoothers)


# --- the assembly exchange, one kernel per sweep axis (ops/assembly_exchange.py) ---

#: HMG-global p=4 hierarchies of the quadrant (hanging faces, cross levels,
#: singletons, irregular groups) and the hypercube (patches only) at a
#: reduced refinement
EXCHANGE_HIERARCHIES = [("quadrant", 5), ("quadrant", 6), ("hypercube", 4)]


@pytest.fixture(scope="module", params=EXCHANGE_HIERARCHIES, ids=lambda c: f"{c[0]}_r{c[1]}")
def exchange_ops(request):
    """{dtype: every level's operator on the card, coarsest first}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.ops.hybrid import make_hybrid_operator

    dev = torch.device("cuda:0")
    geo, r = request.param
    seq = api.geometric_coarsening_sequence(generators.create(geo, 3, r), -1, -1)
    levels = [api.build_level_hybrid(m, 4, dev, torch.float32) for m in seq]
    ops = {torch.float32: [lv.op for lv in levels],
           torch.float64: [make_hybrid_operator(lv.fmt, lv.hanging, dev, torch.float64)
                           for lv in levels]}
    if geo == "quadrant" and r == 6:
        assert any(op.use_cross for op in ops[torch.float32])
    return ops


def exchange_input(op, seed):
    gen = torch.Generator(device=op.device).manual_seed(seed)
    return torch.randn(op.n_slots, generator=gen, dtype=op.dtype, device=op.device)


@pytest.mark.parametrize("dtype", DTYPES)
def test_exchange_kernel_is_the_eager_chain_bit_for_bit(exchange_ops, dtype):
    from dealii_multigrid_tpu_torch.ops import assembly_exchange as ax

    for l, op in enumerate(exchange_ops[dtype]):
        raw = exchange_input(op, 21 + l)
        want = ax.reference_(op, raw.clone())
        before = ax.launches.count
        got = op.exchange_(raw.clone())
        torch.cuda.synchronize()
        assert ax.launches.count - before == op.exchange_plan.launches
        err = float((got - want).abs().max()) if op.n_slots else 0.0
        assert torch.equal(got, want), (
            f"L{l} NP={op.NP} S={op.S} NS={op.NS} cross={op.use_cross}: max_abs_err={err:.3e}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_exchange_kernel_is_bit_repeatable(exchange_ops, dtype):
    for l, op in enumerate(exchange_ops[dtype]):
        raw = exchange_input(op, 31 + l)
        assert torch.equal(op.exchange_(raw.clone()), op.exchange_(raw.clone())), f"L{l}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_captured_exchange_replays_equal_the_eager_chain(exchange_ops, dtype):
    """The finest level's exchange captured in a CUDA graph, in place on a
    static buffer: each replay equals the eager chain on that input."""
    from dealii_multigrid_tpu_torch.ops import assembly_exchange as ax

    op = exchange_ops[dtype][-1]
    buf = exchange_input(op, 40)
    op.exchange_(buf.clone())  # build and initialise outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        op.exchange_(buf)
    for seed in (41, 42):
        raw = exchange_input(op, seed)
        buf.copy_(raw)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(buf, ax.reference_(op, raw.clone()))


def test_bfloat16_levels_on_the_card_take_the_torch_chain(cuda):
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.ops import assembly_exchange as ax

    lv = api.build_level_hybrid(generators.create("quadrant", 3, 4), 4, cuda, torch.bfloat16)
    raw = exchange_input(lv.op, 50)
    assert not ax.takes_kernel(raw)
    before = ax.launches.count
    got = lv.op.exchange_(raw.clone())
    torch.cuda.synchronize()
    assert ax.launches.count == before
    assert torch.equal(got, ax.reference_(lv.op, raw.clone()))
