"""The PyTorch port's algebraic multigrid against the JAX package (CPU, float64).

The host set-up is shared algebra: aggregates and ELL index tables must be
equal integer for integer, values, inverse diagonals and each level's
clamped ``omega`` bit for bit.  The apply (matvec, rmatvec through the
transposed table, the V-cycle with 1 and 2 cycles, both flavours) must
agree to 1e-10 relative.  The three checks of tests/test_amg_clamp.py run
on the port's build_amg.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dealii_multigrid_tpu.mesh import dof as JD, generators as JG
from dealii_multigrid_tpu.solvers import amg as jamg, coarse as jcoarse
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.solvers import amg as tamg, coarse as tcoarse
from dealii_multigrid_tpu_torch.utils.phases import SETUP


def lap2d(n: int) -> sp.csr_matrix:
    e = np.ones(n)
    T = sp.diags([-e, 2.0 * e, -e], [-1, 0, 1], (n, n))
    eye = sp.identity(n)
    return (sp.kron(eye, T) + sp.kron(T, eye)).tocsr()


def quadrant_p1(package):
    """The assembled constrained matrix of quadrant r=3 at p=1, by either
    package's own host code."""
    G, D, C = (JG, JD, jcoarse) if package == "jax" else (TG, TD, tcoarse)
    dofh = D.distribute_dofs(G.create("quadrant", 3, 3), 1)
    return C.assemble_sparse_matrix(dofh, D.make_hanging_node_constraints(dofh))


def matrices(name):
    """(matrix for the JAX package's set-up, matrix for the port's)."""
    if name == "lap2d":
        A = lap2d(24)
        return A, A
    return quadrant_p1("jax"), quadrant_p1("torch")


def strength_graph(A: sp.csr_matrix, theta: float = 0.02) -> sp.csr_matrix:
    d = A.diagonal()
    scale = 1.0 / np.sqrt(np.maximum(d, 1e-300))
    S = (sp.diags(scale) @ abs(A) @ sp.diags(scale)).tocsr()
    S.data[S.data < theta] = 0.0
    S.eliminate_zeros()
    return S


def same_ell(t_ell: tamg.ELLMatrix, j_ell: jamg.ELLMatrix):
    assert t_ell.shape == j_ell.shape
    assert t_ell.idx.dtype == torch.int32
    assert np.array_equal(t_ell.idx.numpy(), np.asarray(j_ell.idx))
    assert np.array_equal(t_ell.vals.numpy(), np.asarray(j_ell.vals))


@pytest.mark.parametrize("name", ["lap2d", "quadrant_p1"])
def test_assembled_matrix_and_aggregates_equal_jax(name):
    Aj, At = matrices(name)
    assert np.array_equal(Aj.indptr, At.indptr) and np.array_equal(Aj.indices, At.indices)
    assert np.array_equal(Aj.data, At.data)
    aj = jamg._greedy_aggregate(strength_graph(Aj))
    at = tamg._greedy_aggregate(strength_graph(At))
    assert at.dtype == aj.dtype and np.array_equal(at, aj)
    assert at.min() == 0 and at.max() + 1 < At.shape[0]


@pytest.mark.parametrize("flavor", ["sa", "boomer"])
@pytest.mark.parametrize("name", ["lap2d", "quadrant_p1"])
def test_hierarchy_tables_and_omegas_equal_jax(name, flavor):
    Aj, At = matrices(name)
    jb, tb = (
        (jamg.build_amg, tamg.build_amg) if flavor == "sa"
        else (jamg.build_amg_boomer, tamg.build_amg_boomer)
    )
    j = jb(Aj, dtype=jnp.float64, coarse_size=100)
    t = tb(At, dtype=torch.float64, device="cpu", coarse_size=100)
    assert len(t.levels) == len(j.levels) >= 2
    assert (t.n_cycles, t.n_smooth) == (j.n_cycles, j.n_smooth)
    for tl, jl in zip(t.levels, j.levels):
        same_ell(tl.A, jl.A)
        assert tl.omega == jl.omega          # bit for bit (default_rng(12))
        assert np.array_equal(tl.inv_diag.numpy(), np.asarray(jl.inv_diag))
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            same_ell(tl.P, jl.P)
            # the transposed table holds the same entries
            Pt = sp.csr_matrix(
                (tl.P.t.vals.numpy().ravel(),
                 (np.repeat(np.arange(tl.P.t.shape[0]), tl.P.t.K), tl.P.t.idx.numpy().ravel())),
                shape=tl.P.t.shape,
            )
            P = sp.csr_matrix(
                (tl.P.vals.numpy().ravel(),
                 (np.repeat(np.arange(tl.P.shape[0]), tl.P.K), tl.P.idx.numpy().ravel())),
                shape=tl.P.shape,
            )
            assert abs(Pt - P.T).max() == 0.0
    cj = np.asarray(j.chol)
    assert np.abs(t.chol.numpy() - cj).max() <= 1e-12 * np.abs(cj).max()
    rows = [d["rows"] for d in t.describe()]
    assert rows == [lv.A.shape[0] for lv in j.levels]
    assert all(d["bytes"] > 0 and d["K_A"] >= 1 for d in t.describe())


@pytest.mark.parametrize("flavor,n_cycles", [("sa", 1), ("sa", 2), ("boomer", 1), ("boomer", 2)])
def test_matvec_rmatvec_and_vmult_match_jax(flavor, n_cycles):
    Aj, At = matrices("quadrant_p1")
    jb, tb = (
        (jamg.build_amg, tamg.build_amg) if flavor == "sa"
        else (jamg.build_amg_boomer, tamg.build_amg_boomer)
    )
    j = jb(Aj, dtype=jnp.float64, coarse_size=100, n_cycles=n_cycles)
    t = tb(At, dtype=torch.float64, device="cpu", coarse_size=100, n_cycles=n_cycles)
    rng = np.random.default_rng(7)

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-10 * np.abs(want).max()

    x = rng.standard_normal(At.shape[0])
    close(t.levels[0].A.matvec(torch.as_tensor(x)), j.levels[0].A.matvec(jnp.asarray(x)))
    close(t.levels[0].A.matvec(torch.as_tensor(x)), At @ x)
    tP, jP = t.levels[1].P, j.levels[1].P
    xc = rng.standard_normal(tP.shape[1])
    close(tP.matvec(torch.as_tensor(xc)), jP.matvec(jnp.asarray(xc)))
    close(tP.rmatvec(torch.as_tensor(x)), jP.rmatvec(jnp.asarray(x)))
    close(t.vmult(torch.as_tensor(x)), j.vmult(jnp.asarray(x)))


def test_rmatvec_needs_the_transposed_table():
    A = tamg._to_ell(lap2d(4), torch.float64)
    with pytest.raises(ValueError, match="transpose"):
        A.rmatvec(torch.ones(16, dtype=torch.float64))


def _amg_stage_counts() -> dict:
    """How often each AMG set-up stage ran in the process (``SETUP``)."""
    out = dict.fromkeys(("mgtpu.setup.amg_build", "mgtpu.setup.amg_upload", "mgtpu.setup.amg_factor"), 0)
    for r in SETUP.records():
        if r.name in out:
            out[r.name] += r.count
    return out


def test_float32_levels_keep_their_dtype():
    before = _amg_stage_counts()
    t = tamg.build_amg(lap2d(24), dtype=torch.float32, device="cpu", coarse_size=100)
    assert t.chol.dtype == torch.float32
    assert all(lv.A.vals.dtype == torch.float32 for lv in t.levels)
    y = t.vmult(torch.ones(24 * 24))
    assert y.dtype == torch.float32 and bool(torch.isfinite(y).all())
    # each set-up stage ran once, as a set-up span
    assert _amg_stage_counts() == {k: n + 1 for k, n in before.items()}


def scaled_eigs(A: sp.csr_matrix) -> np.ndarray:
    """Eigenvalues of D^-1 A (via the similar SPD D^-1/2 A D^-1/2)."""
    Dm = sp.diags(1.0 / np.sqrt(A.diagonal()))
    return np.linalg.eigvalsh((Dm @ A @ Dm).toarray())


def test_lam_max_estimate_within_headroom():
    A = lap2d(16)
    est = tamg._lam_max_dinv_a(A, A.diagonal())
    assert est == jamg._lam_max_dinv_a(A, A.diagonal())
    true = scaled_eigs(A).max()
    assert 0.95 * true <= est <= 1.15 * true, (est, true)


def test_clamp_restores_smoother_convergence():
    """omega=1.5 on the 2D Laplacian (lambda_max(D^-1 A) ~ 2) is a divergent
    Jacobi weight; the clamp must pull the fine level back into the
    convergent regime while the unclamped weight provably diverges."""
    A = lap2d(16)
    evs = scaled_eigs(A)
    pre = tamg.build_amg(A, dtype=torch.float64, device="cpu", omega=1.5, coarse_size=40)
    om0 = pre.levels[0].omega
    assert om0 < 1.5, "clamp did not activate on the fine level"
    assert om0 * evs.max() < 2.0 * 1.01  # the spectral safety rule
    assert np.max(np.abs(1.0 - 1.5 * evs)) > 1.0   # nominal weight amplifies
    assert np.max(np.abs(1.0 - om0 * evs)) < 1.0   # clamped weight contracts
    # ten sweeps of the port's smoother must not grow the residual
    rng = np.random.default_rng(5)
    b = torch.as_tensor(rng.normal(size=A.shape[0]))
    lev = pre.levels[0]
    x = torch.zeros_like(b)
    for _ in range(5):
        x = pre._smooth(lev, x, b)  # n_smooth = 2 sweeps each
    assert float(torch.linalg.norm(b - lev.A.matvec(x))) < float(torch.linalg.norm(b))


def test_clamp_inactive_for_safe_nominal_weight():
    """The ML-analog default (2/3) is already safe on the Laplacian: the
    clamp must leave it untouched."""
    pre = tamg.build_amg(lap2d(16), dtype=torch.float64, device="cpu", omega=2.0 / 3.0,
                         coarse_size=40)
    assert pre.levels[0].omega == 2.0 / 3.0
