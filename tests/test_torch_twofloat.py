"""The port's double-single arithmetic (solvers/twofloat.py) against float64
and against the JAX package's twofloat module (CPU).

two_sum and two_prod must be exact: the pair they return equals the float64
sum or product bit for bit.  tf_dot agrees with JAX's to 1e-6 relative, and
the df32 CG takes JAX's iteration count on a small seeded SPD system.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.solvers import twofloat as jtf
from dealii_multigrid_tpu_torch.solvers import twofloat as ttf

N_PAIRS = 100_000


def f32(seed, n=N_PAIRS, scale=1.0):
    rng = np.random.default_rng(seed)
    # spread the exponents so the cancellations and carries vary
    return (rng.standard_normal(n) * scale * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_two_sum_exact(scale):
    a, b = f32(1), f32(2, scale=scale)
    s, e = ttf.two_sum(torch.as_tensor(a), torch.as_tensor(b))
    assert s.dtype == torch.float32 and e.dtype == torch.float32
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    assert np.array_equal(got, a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_exact():
    a, b = f32(3), f32(4)
    p, e = ttf.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    # an f32 x f32 product is exact in f64, so the pair must equal it bitwise
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    assert np.array_equal(got, a.astype(np.float64) * b.astype(np.float64))


def test_two_prod_exact_with_a_scalar():
    """The CG's scalars are 0-d tensors: their split rounds in f32 too."""
    a = torch.tensor(np.float32(0.372817))
    b = f32(5)
    p, e = ttf.two_prod(a, torch.as_tensor(b))
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    assert np.array_equal(got, np.float64(a.item()) * b.astype(np.float64))


def test_split_roundtrip():
    x64 = np.random.default_rng(7).standard_normal(4096) * 1e3
    pair = ttf.tf_split_f64_host(x64)
    assert pair.hi.dtype == torch.float32 and pair.lo.dtype == torch.float32
    rt = ttf.tf_to_f64(pair).numpy()
    # a pair carries ~48 mantissa bits: near-exact, not bitwise
    assert np.max(np.abs(rt - x64) / np.abs(x64)) < 2.0**-45
    assert np.array_equal(ttf.tf_round(pair).numpy(), (pair.hi + pair.lo).numpy())
    # the same split from a tensor
    again = ttf.tf_split_f64_host(torch.as_tensor(x64))
    assert torch.equal(again.hi, pair.hi) and torch.equal(again.lo, pair.lo)


def test_updates_match_jax():
    rng = np.random.default_rng(9)
    x64, p64 = rng.standard_normal(2048), rng.standard_normal(2048)
    v = rng.standard_normal(2048).astype(np.float32)
    alpha = np.float32(0.37281)
    tx, tp = ttf.tf_split_f64_host(x64), ttf.tf_split_f64_host(p64)
    jx, jp = jtf.tf_split_f64_host(x64), jtf.tf_split_f64_host(p64)
    cases = [
        (ttf.tf_add(tx, tp), jtf.tf_add(jx, jp)),
        (ttf.tf_axpy(alpha, tp, tx), jtf.tf_axpy(alpha, jp, jx)),
        (ttf.tf_axpy_f32(alpha, torch.as_tensor(v), tx), jtf.tf_axpy_f32(alpha, jnp.asarray(v), jx)),
        (ttf.tf_xpby(torch.as_tensor(v), alpha, tp), jtf.tf_xpby(jnp.asarray(v), alpha, jp)),
    ]
    for got, want in cases:
        g = ttf.tf_to_f64(got).numpy()
        w = np.asarray(want.hi, np.float64) + np.asarray(want.lo, np.float64)
        assert np.max(np.abs(g - w)) <= 1e-13 * np.max(np.abs(w))


@pytest.mark.parametrize("weighted", [False, True])
def test_tf_dot_matches_jax(weighted):
    rng = np.random.default_rng(13)
    a64, b64 = rng.standard_normal(1 << 16), rng.standard_normal(1 << 16)
    w = (rng.uniform(size=1 << 16) < 0.7).astype(np.float32) if weighted else None
    got = float(ttf.tf_dot(
        ttf.tf_split_f64_host(a64), ttf.tf_split_f64_host(b64),
        None if w is None else torch.as_tensor(w),
    ))
    want = float(jtf.tf_dot(
        jtf.tf_split_f64_host(a64), jtf.tf_split_f64_host(b64),
        None if w is None else jnp.asarray(w),
    ))
    assert abs(got - want) <= 1e-6 * abs(want)
    exact = float(a64 @ (b64 if w is None else b64 * w))
    assert abs(got - exact) <= 1e-5 * abs(exact)
    v = b64.astype(np.float32)
    got = float(ttf.tf_dot_f32(ttf.tf_split_f64_host(a64), torch.as_tensor(v)))
    want = float(jtf.tf_dot_f32(jtf.tf_split_f64_host(a64), jnp.asarray(v)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_cg_df32_takes_the_jax_iteration_count():
    rng = np.random.default_rng(17)
    n = 200
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a64 = (q * np.geomspace(1.0, 10.0, n)) @ q.T  # 29 iterations at 1e-8
    b64 = rng.standard_normal(n)
    a32 = a64.astype(np.float32)
    d32 = np.diag(a64).astype(np.float32)
    ta, td = torch.as_tensor(a32), torch.as_tensor(d32)
    ja, jd = jnp.asarray(a32), jnp.asarray(d32)
    got = ttf.cg_solve_df32(
        lambda v: ta @ v, ttf.tf_split_f64_host(b64), preconditioner=lambda r: r / td,
        reltol=1e-8, maxiter=1000,
    )
    want = jtf.cg_solve_df32(
        lambda v: ja @ v, jtf.tf_split_f64_host(b64), preconditioner=lambda r: r / jd,
        reltol=1e-8, maxiter=1000,
    )
    assert got.converged and bool(want.converged)
    assert got.n_iterations == int(want.n_iterations)
    x = ttf.tf_to_f64(got.x).numpy()
    xj = np.asarray(want.x.hi, np.float64) + np.asarray(want.x.lo, np.float64)
    assert np.linalg.norm(x - xj) <= 1e-6 * np.linalg.norm(xj)


def test_df32_path_is_plain_eager_ops():
    """No compiled or fused ops that could contract a*b - c into an FMA."""
    tree = ast.parse(inspect.getsource(ttf))
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
    assert not names & {"compile", "addcmul", "addcdiv", "addmm", "fma", "triton", "jit"}
