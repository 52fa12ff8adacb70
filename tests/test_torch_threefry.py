"""The port's threefry draws (utils/threefry.py) against jax.random.

Bits, uniforms and normals must equal JAX's bit for bit, in every width and
dtype; each normal case also prints its largest gap in ulp and the share of
entries that are bit-equal (run with ``-s``).  The emulated fused
multiply-adds are held to exact rational arithmetic, on inputs where two
roundings give another result.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu_torch.utils import threefry

SEEDS = [0, 42, 2**32 + 7]
# every seed at small sizes; 2**20 + 3 entries for 42, the seed the solvers draw
CASES = [(seed, n) for seed in SEEDS for n in (0, 1, 7, 1000)] + [(42, 2**20 + 3)]
DTYPES = {  # torch dtype: (jax dtype, integer view, mantissa bits)
    torch.float64: (jnp.float64, torch.int64, 52),
    torch.float32: (jnp.float32, torch.int32, 23),
    torch.bfloat16: (jnp.bfloat16, torch.int16, 7),
}


def _jax_as_torch(x, dtype):
    """A JAX array as a torch tensor with the same bits."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = DTYPES[a.dtype][1]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def test_jax_defaults_are_the_ones_copied():
    """A JAX with another PRNG or the non-partitionable threefry would draw
    other vectors; this case fails rather than letting the packages part."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed,n", CASES)
def test_bits_equal_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    for width in (8, 16, 32, 64):
        ref = np.asarray(jax.random.bits(key, (n,), getattr(jnp, f"uint{width}")))
        got = threefry.random_bits(seed, n, width)
        assert got.dtype == ref.dtype and got.shape == (n,)
        np.testing.assert_array_equal(got, ref, err_msg=f"width {width}")


@pytest.mark.parametrize("seed,n", CASES)
def test_uniform_equals_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    for dtype, (jdt, _, _) in DTYPES.items():
        for lo, hi in [(0.0, 1.0), (-3.7, 5.1)]:
            ref = _jax_as_torch(jax.random.uniform(key, (n,), jdt, lo, hi), dtype)
            got = threefry.uniform(seed, n, dtype, lo, hi)
            assert _bits_equal(got, ref), (dtype, lo, hi)


@pytest.mark.parametrize("seed,n", CASES)
def test_normal_matches_jax(seed, n):
    key = jax.random.PRNGKey(seed)
    for dtype, (jdt, _, nmant) in DTYPES.items():
        ref = _jax_as_torch(jax.random.normal(key, (n,), jdt), dtype)
        got = threefry.normal(seed, n, dtype)
        assert got.dtype == dtype and got.shape == (n,)
        a, b = got.double(), ref.double()
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0**-126))) - nmant)
        worst = float(((a - b).abs() / ulp).max()) if n else 0.0
        same = float((a == b).double().mean()) if n else 1.0
        print(f"seed {seed} n {n} {dtype}: max gap {worst} ulp, bit-equal share {same}")
        assert _bits_equal(got, ref), (dtype, worst, same)


def _round_once(x: Fraction, dtype: torch.dtype) -> float:
    """The exact x rounded to nearest even in ``dtype`` (float64 or float32)."""
    if dtype == torch.float64:
        return float(x)  # Fraction's division rounds once
    near = np.float32(float(x))  # within one float32 ulp of x
    candidates = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    return float(min(candidates, key=lambda v: (abs(Fraction(float(v)) - x), int(v.view(np.int32)) & 1)))


def test_emulated_fma_rounds_once():
    """XLA's CPU code fuses each Horner step into one FMA.  The float64 case
    below rounds twice under ``s + (e + f)``: the exact sum lies just under
    the midpoint of 1 + 2**-52 and 1 + 2**-51."""
    a, b, c = 1 + 2.0**-37, 2.0**-53 * (1 - 2.0**-37), 1 + 2.0**-52
    got = threefry._fma64(torch.tensor([a], dtype=torch.float64), b,
                          torch.tensor([c], dtype=torch.float64)).item()
    assert got == _round_once(Fraction(a) * Fraction(b) + Fraction(c), torch.float64) == 1 + 2.0**-52
    rng = np.random.default_rng(0)
    for dtype in (torch.float64, torch.float32):
        x = [torch.tensor(rng.standard_normal(2000) * 2.0 ** rng.integers(-30, 30, 2000),
                          dtype=torch.float64).to(dtype) for _ in range(3)]
        x[2] = torch.where(torch.arange(2000) % 2 == 0, -(x[0] * x[1]), x[2])  # cancellation
        fma = threefry._fma64 if dtype == torch.float64 else threefry._fma32
        got = fma(*x).tolist()
        want = [_round_once(Fraction(p) * Fraction(q) + Fraction(r), dtype)
                for p, q, r in zip(*(v.tolist() for v in x))]
        assert got == want, dtype


@pytest.mark.parametrize("seed", SEEDS)
def test_draw_is_prefix_of_longer_draw(seed):
    """A level of n entries takes the first n of the hierarchy's one draw
    (solvers/chebyshev.estimate_eigenvalue_ranges); JAX draws each level on
    its own, so the prefix must hold in both."""
    key = jax.random.PRNGKey(seed)
    for dtype, (jdt, _, _) in DTYPES.items():
        long_port = threefry.normal(seed, 5000, dtype)
        long_jax = _jax_as_torch(jax.random.normal(key, (5000,), jdt), dtype)
        for n in (1, 7, 1000, 4999):
            assert _bits_equal(threefry.normal(seed, n, dtype), long_port[:n])
            assert _bits_equal(_jax_as_torch(jax.random.normal(key, (n,), jdt), dtype),
                               long_jax[:n])


def test_hierarchy_estimates_take_prefixes_of_one_draw():
    """``estimate_eigenvalue_ranges`` with None start vectors draws once per
    dtype and hands each level its prefix: every level's estimate equals
    the one from that level's own draw, as the JAX package makes it."""
    from dealii_multigrid_tpu_torch import api
    from dealii_multigrid_tpu_torch.mesh import generators
    from dealii_multigrid_tpu_torch.mesh.coarsening import geometric_coarsening_sequence
    from dealii_multigrid_tpu_torch.solvers import chebyshev

    meshes = geometric_coarsening_sequence(generators.create("quadrant", 2, 3))
    levels = [api.build_level(m, 2, "cpu", dt)
              for m in meshes for dt in (torch.float64, torch.float32)]
    ops, diags = [lv.op for lv in levels], [lv.inv_diag for lv in levels]
    assert len({d.shape[0] for d in diags}) == len(meshes)
    batched = chebyshev.estimate_eigenvalue_ranges(ops, diags, None)
    own = [chebyshev.estimate_eigenvalue_range(op, d, threefry.normal(42, d.shape[0], d.dtype))
           for op, d in zip(ops, diags)]
    assert batched == own
    assert chebyshev.estimate_eigenvalue_range(ops[0], diags[0]) == own[0]
