"""bfloat16 multigrid levels in the port against the JAX package (CPU).

On the CPU the port's stencil is its plain tensordot chain; in bfloat16 it
equals the JAX package's XLA chain of ``HybridOperator.cell_apply_raw`` bit
for bit.  That chain is the reference, because the Pallas kernel itself
refuses bfloat16 inputs (its float32 dot result is stored into a bfloat16
output).  A bfloat16 vmult and transfer of the port agree with the JAX
package's to 3e-2 of max|ref| (the two round at other places); the dense
and AMG coarse factors are float32 under bfloat16 levels; fixed-order sums
in bfloat16 add their padding zero exactly; a CLI row with MGNumberType
bfloat16 converges.  The solve counts against the JAX package are in
tests/test_torch_bf16_solve.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.mesh.coarsening import geometric_coarsening_sequence as jcoarsen
from dealii_multigrid_tpu.ops import hybrid_transfer as JT
from dealii_multigrid_tpu.ops import pallas_stencil as jps
from dealii_multigrid_tpu_torch import api as tapi, cli
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence as tcoarsen
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps
from dealii_multigrid_tpu_torch.ops.fixed_order import FixedOrderSum
from dealii_multigrid_tpu_torch.ops.hybrid_transfer import make_hybrid_transfer
from dealii_multigrid_tpu_torch.solvers.amg import build_amg
from dealii_multigrid_tpu_torch.solvers.coarse import (
    assemble_sparse_matrix, make_direct_coarse_solver,
)

CPU = torch.device("cpu")
BF = torch.bfloat16
#: port against JAX in bfloat16: max|err| / max|ref|
BF16_REL = 3e-2


def banded(S: int, band: int, rng) -> np.ndarray:
    i, j = np.indices((S, S))
    return np.where(abs(i - j) <= band, rng.standard_normal((S, S)), 0.0)


def jax_chain(xp, KS, MS, pscale, S):
    """The JAX package's cell_apply_raw patch branch (precision HIGHEST)."""
    up = xp.reshape(-1, S, S, S)

    def ax(u, mat, axis):
        return jnp.moveaxis(jnp.tensordot(u, mat, axes=([axis], [1]),
                                          precision=jax.lax.Precision.HIGHEST), -1, axis)

    kx = ax(ax(ax(up, KS, 1), MS, 2), MS, 3)
    ky = ax(ax(ax(up, MS, 1), KS, 2), MS, 3)
    kz = ax(ax(ax(up, MS, 1), MS, 2), KS, 3)
    return ((kx + ky + kz) * pscale[:, None, None, None]).reshape(xp.shape)


def bf16_inputs(S, band, NP=8, seed=0):
    """Random inputs rounded to bfloat16, as float32 arrays (exact)."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((NP, S**3)), banded(S, band, rng), banded(S, band, rng),
            rng.uniform(0.5, 2.0, NP))
    return [torch.as_tensor(a, dtype=BF).float().numpy() for a in arrs]


@pytest.mark.parametrize("S,band", [(9, 2), (17, 4)])
def test_plain_bf16_stencil_is_bit_equal_to_jax_chain(S, band):
    args = bf16_inputs(S, band)
    want = np.asarray(jax_chain(*(jnp.asarray(a, jnp.bfloat16) for a in args), S), np.float32)
    got = ps.patch_stencil(*(torch.as_tensor(a).to(BF) for a in args), band)
    assert got.dtype == BF
    assert np.array_equal(got.float().numpy(), want)
    # both lie within bfloat16 roundoff of the float64 stencil
    ref64 = ps.patch_stencil_reference(*(torch.as_tensor(a, dtype=torch.float64) for a in args))
    err = float((got.double() - ref64).abs().max() / ref64.abs().max())
    print(f"S={S} band={band}: plain bf16 vs float64 {err:.3e} of max|ref|")
    assert err <= 2e-2


@pytest.mark.skipif(not jps.HAVE_PALLAS, reason="pallas unavailable")
def test_pallas_kernel_refuses_bf16():
    """Why the XLA chain is the reference: the Pallas kernel stores its
    float32 dot result into a bfloat16 output and fails (a fault of the JAX
    package, which is not changed)."""
    args = bf16_inputs(9, 2, NP=2)
    with pytest.raises(Exception, match="dtype"):
        jps.patch_stencil_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in args), 9,
                                 interpret=True)


def test_wrapper_takes_bf16_and_checks_dtypes():
    xp, KS, MS, sc = (torch.as_tensor(a).to(BF) for a in bf16_inputs(9, 2, NP=2))
    before = ps.launches.count
    assert torch.equal(ps.patch_stencil(xp, KS, MS, sc, 2), ps.patch_stencil_reference(xp, KS, MS, sc))
    assert ps.launches.count == before  # the plain CPU path counts no launch
    with pytest.raises(ValueError, match="KS is torch.float32"):
        ps.patch_stencil(xp, KS.float(), MS, sc, 2)
    with pytest.raises(ValueError, match="float32, float64 or bfloat16"):
        ps.patch_stencil(*(t.half() for t in (xp, KS, MS, sc)), 2)


def test_number_dtype_bfloat16():
    assert tapi.number_dtype("bfloat16") == BF == torch.bfloat16
    assert japi.number_dtype("bfloat16") == jnp.bfloat16


def levels_pair(r: int, p: int):
    jm, tm = jcoarsen(JG.create("quadrant", 3, r)), tcoarsen(TG.create("quadrant", 3, r))
    jl = [japi.build_level_hybrid(m, p, jnp.bfloat16) for m in jm[-2:]]
    tl = [tapi.build_level_hybrid(m, p, CPU, BF) for m in tm[-2:]]
    return jl, tl


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("r,p", [(2, 2), (3, 2)])
def test_bf16_vmult_and_transfer_match_jax(r, p):
    jl, tl = levels_pair(r, p)
    fine_j, fine_t = jl[-1], tl[-1]
    assert fine_t.op.dtype == BF and fine_t.op.NP == fine_j.op.NP
    b = np.random.default_rng(r).standard_normal(fine_t.dofh.n_dofs)
    x = fine_t.fmt.from_global(b)   # consistent slot vector
    err_v = rel(fine_t.op.vmult(torch.as_tensor(x, dtype=BF)),
                fine_j.op.vmult(jnp.asarray(x, jnp.bfloat16)))
    jtr = JT.make_hybrid_transfer(jl[1].fmt, jl[0].fmt, jl[1].op, jl[0].op, dtype=jnp.bfloat16)
    ttr = make_hybrid_transfer(tl[1].fmt, tl[0].fmt, tl[1].op, tl[0].op)
    rt = ttr.restrict(torch.as_tensor(x, dtype=BF))
    assert rt.dtype == BF
    err_r = rel(rt, jtr.restrict(jnp.asarray(x, jnp.bfloat16)))
    xc = tl[0].fmt.from_global(np.random.default_rng(r + 1).standard_normal(tl[0].dofh.n_dofs))
    err_p = rel(ttr.prolong(torch.as_tensor(xc, dtype=BF)), jtr.prolong(jnp.asarray(xc, jnp.bfloat16)))
    print(f"r={r} p={p} bf16 port vs JAX: vmult {err_v:.3e}, restrict {err_r:.3e}, "
          f"prolong {err_p:.3e} of max|ref| (limit {BF16_REL})")
    assert max(err_v, err_r, err_p) <= BF16_REL


def test_coarse_factors_are_float32_under_bf16_levels():
    dofh = TD.distribute_dofs(TG.create("quadrant", 3, 2), 2)
    hanging = TD.make_hanging_node_constraints(dofh)
    direct = make_direct_coarse_solver(dofh, hanging, BF, CPU)
    assert direct.L.dtype == torch.float32
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(dofh.n_dofs), dtype=BF)
    x = direct(b)
    assert x.dtype == BF and bool(torch.isfinite(x).all())
    A = assemble_sparse_matrix(dofh, hanging)
    amg = build_amg(A, dtype=BF, device="cpu", coarse_size=50)
    assert len(amg.levels) >= 2 and amg.chol.dtype == torch.float32
    assert all(lev.A.vals.dtype == BF and lev.inv_diag.dtype == BF for lev in amg.levels)
    y = amg.vmult(b)
    assert y.dtype == BF and bool(torch.isfinite(y).all())


def test_fixed_order_sum_in_bf16_adds_its_padding_zero_exactly():
    """A padded table sums each row in bfloat16 exactly as in float32
    rounded once: the explicit zero adds nothing."""
    targets = np.array([0, 2, 2, 3, 3, 3, 0, -1, 5])
    fos = FixedOrderSum.build(targets, 6, CPU)
    assert not fos.full and fos.width == 3
    src = torch.as_tensor(np.random.default_rng(1).standard_normal(len(targets)), dtype=BF)
    got = fos.scatter(src)
    want = FixedOrderSum.build(targets, 6, CPU).scatter(src.float()).to(BF)
    assert got.dtype == BF and torch.equal(got, want)


def test_cli_row_with_bf16_levels(tmp_path, capsys):
    cfg = {"Type": "HMG-global", "GeometryType": "quadrant", "NRefGlobal": 2, "Degree": 2,
           "MGNumberType": "bfloat16", "NumberType": "float", "CoarseGridSolverType": "amg",
           "SmootherDegree": 3, "NRepetitions": 1}
    path = tmp_path / "input_0000.json"
    path.write_text(json.dumps(cfg))
    assert cli.main([str(path), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    top = max(i for i, ln in enumerate(lines) if ln.startswith("dim "))
    row = dict(zip(lines[top].split(), lines[top + 1].split()))
    assert row["mg_number"] == "bfloat16" and row["number"] == "float"
    assert row["converged"] == "True" and int(row["n_iterations"]) > 0
