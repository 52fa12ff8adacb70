"""The PyTorch port's Chebyshev smoother and eigenvalue estimate match JAX.

One HMG-global level (quadrant r=4, p=3, float64) is built by the JAX
package; the port applies the same tables (``from_arrays``), the same
inverse diagonal and the same seed-42 start vector.  The CG-Lanczos
eigenvalue estimate and Chebyshev ``vmult`` / ``step`` must agree to 1e-10
relative.

The fused step (ops/chebyshev_step.py) is checked here without a card: the
operator's split gives ``vmult`` bit for bit, its plain version gives the
eager chain bit for bit, and the path rule picks the kernel only for an
operator with the split and a float32 or float64 CUDA vector.  The kernel
itself is held to the eager chain in tests/test_torch_cuda.py.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu import api as japi
from dealii_multigrid_tpu.mesh import generators as JG
from dealii_multigrid_tpu.solvers import chebyshev as JC
from dealii_multigrid_tpu_torch import api as tapi
from dealii_multigrid_tpu_torch.mesh import dof as TD, generators as TG
from dealii_multigrid_tpu_torch.ops import chebyshev_step as TCS
from dealii_multigrid_tpu_torch.ops.hybrid import HybridOperator
from dealii_multigrid_tpu_torch.ops.hybrid_format import build_hybrid_format
from dealii_multigrid_tpu_torch.solvers import chebyshev as TC
from dealii_multigrid_tpu_torch.solvers import local_smoothing as TLS
from dealii_multigrid_tpu_torch.utils.params import MultigridParameters

TOL = 1e-10


def host_tree(v):
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(host_tree(e) for e in v)
    return np.asarray(v)


@pytest.fixture(scope="module")
def lvl():
    jl = japi.build_level_hybrid(JG.create("quadrant", 3, 4), 3, jnp.float64)
    tables = {k: host_tree(getattr(jl.op, k)) for k in HybridOperator.TABLE_KEYS}
    meta = {k: getattr(jl.op, k) for k in HybridOperator.META_KEYS}
    op = HybridOperator.from_arrays(tables, meta, torch.device("cpu"), torch.float64)
    inv_diag = torch.as_tensor(np.array(jl.inv_diag))
    b0 = torch.as_tensor(np.array(jl.eig_b0))
    return jl, op, inv_diag, b0


def test_eigenvalue_estimate_matches_jax(lvl):
    jl, op, inv_diag, b0 = lvl
    want = JC.estimate_eigenvalue_range(
        jl.op, jl.inv_diag, 20, use_op_dot=True, b0=jl.eig_b0
    )
    got = TC.estimate_eigenvalue_range(op, inv_diag, b0, 20, use_op_dot=True)
    assert abs(got[0] - want[0]) <= TOL * abs(want[0])
    assert abs(got[1] - want[1]) <= TOL * abs(want[1])
    # the batched hierarchy entry point is the same estimate per level
    assert TC.estimate_eigenvalue_ranges([op], [inv_diag], [b0], 20, True) == [got]


@pytest.mark.parametrize("degree", [1, 3, 5])
def test_chebyshev_vmult_and_step_match_jax(lvl, degree):
    jl, op, inv_diag, _ = lvl
    lam = 2.19
    jsm = JC.ChebyshevSmoother.create(
        jl.op, jl.inv_diag, degree=degree, smoothing_range=20.0,
        max_eigenvalue=1.2 * lam,
    )
    sm = TC.ChebyshevSmoother.create(
        op, inv_diag, max_eigenvalue=1.2 * lam, degree=degree, smoothing_range=20.0
    )
    rng = np.random.default_rng(3)
    n = jl.dofh.n_dofs
    b = jl.fmt.from_global(rng.normal(size=n))
    x = jl.fmt.from_global(rng.normal(size=n))
    want = np.asarray(jax.jit(jsm.vmult)(jnp.asarray(b)))
    got = sm.vmult(torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    want = np.asarray(jax.jit(jsm.step)(jnp.asarray(x), jnp.asarray(b)))
    got = sm.step(torch.as_tensor(x), torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


# --- one kernel per step (ops/chebyshev_step.py): the split and the path rule ---

CPU = torch.device("cpu")
FUSED_DTYPES = [torch.float32, torch.float64]
LEVELS = ["hmg_global", "local_smoothing"]


@functools.lru_cache(maxsize=None)
def port_level(kind, dtype):
    """(the smoother's operator, its hybrid operator, inverse diagonal): an
    HMG-global level with hanging faces (quadrant r=3 p=4), or the finest
    ``LSHybridLevel`` of a local-smoothing hierarchy (quadrant r=3 p=2),
    whose identity on boundary and edge slots is the blend."""
    mesh = TG.create("quadrant", 3, 3)
    if kind == "hmg_global":
        lv = tapi.build_level_hybrid(mesh, 4, CPU, dtype)
        assert lv.op.sf_levels and float((lv.op.constrained_keep == 0).sum()) > 0
        return lv.op, lv.op, lv.inv_diag
    mg = MultigridParameters()
    mg.smoother.degree = 3
    dofh = TD.distribute_dofs(mesh, 2)
    ls = TLS.build_local_smoothing_mg_hybrid(dofh, build_hybrid_format(dofh, K=8), mg, CPU, dtype)
    lv = ls.levels[-1]
    assert isinstance(lv, TLS.LSHybridLevel)
    return lv, lv.op, lv.inv_diag


def vectors(n, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=gen, dtype=torch.float64).to(dtype) for _ in range(2)]


def unsplit_vmult(op, x):
    """``HybridOperator.vmult`` as it was before ``vmult_split``."""
    r = op.apply_ct(op.exchange(op.apply_ct_faces(op.cell_apply_raw(op.apply_c(x)))))
    return r * op.constrained_keep + x * (1.0 - op.constrained_keep)


def eager_smoother(sm, vmult, x, b):
    """``ChebyshevSmoother.vmult`` (x None) or ``step`` as they were before
    the fused step, with the operator application ``vmult``."""
    theta, delta, sigma = sm._scalars(b.dtype)
    if x is None:
        d = (sm.inv_diag * b) / float(theta)
        x = d
    else:
        r = b - vmult(x)
        d = (sm.inv_diag * r) / float(theta)
        x = x + d
    rho_old = 1.0 / sigma
    for _ in range(sm.degree - 1):
        r = b - vmult(x)
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = (rho * rho_old) * d + (2.0 * rho / delta) * (sm.inv_diag * r)
        x = x + d
        rho_old = rho
    return x


@pytest.mark.parametrize("dtype", FUSED_DTYPES)
@pytest.mark.parametrize("kind", LEVELS)
def test_split_vmult_equals_the_unsplit_one(kind, dtype):
    op, hop, _ = port_level(kind, dtype)
    x, _ = vectors(hop.n_slots, dtype, 5)
    want = unsplit_vmult(hop, x)
    ar, keep = op.vmult_split(x)
    assert keep is hop.constrained_keep
    assert torch.equal(op.vmult(x), want)
    assert torch.equal(TCS.blend(ar, keep, x), want)


@pytest.mark.parametrize("method", ["vmult", "step"])
@pytest.mark.parametrize("dtype", FUSED_DTYPES)
@pytest.mark.parametrize("kind", LEVELS)
def test_fused_step_plain_version_equals_the_eager_chain(monkeypatch, kind, dtype, method):
    """The plain version of the fused step, standing in for the kernel and
    reached through the operator's split, gives today's smoother bit for
    bit; so does the CPU's own path, which never calls the kernel."""
    op, hop, inv_diag = port_level(kind, dtype)
    sm = TC.ChebyshevSmoother.create(op, inv_diag, max_eigenvalue=1.2 * 2.19, degree=3)
    x, b = vectors(hop.n_slots, dtype, 6)
    args = (b,) if method == "vmult" else (x, b)
    want = eager_smoother(sm, lambda v: unsplit_vmult(hop, v), None if method == "vmult" else x, b)

    def refuse(*_):
        raise AssertionError("a CPU smoother called the fused step")

    with monkeypatch.context() as m:
        m.setattr(TCS, "recurrence_step", refuse)
        m.setattr(TCS, "first_step", refuse)
        assert torch.equal(getattr(sm, method)(*args), want)
    monkeypatch.setattr(TC, "takes_kernel", lambda o, v: hasattr(o, "vmult_split"))
    calls = []
    for name, plain in (("recurrence_step", TCS.recurrence_reference),
                        ("first_step", TCS.first_reference)):
        def fused(ar, keep, x, *rest, plain=plain):
            calls.append(plain)
            return plain(TCS.blend(ar, keep, x), x, *rest)

        monkeypatch.setattr(TCS, name, fused)
    assert torch.equal(getattr(sm, method)(*args), want)
    assert len(calls) == sm.degree - (method == "vmult")


@pytest.mark.parametrize("step", ["recurrence_step", "first_step"])
def test_the_kernel_entry_points_refuse_cpu_tensors(step):
    """A CPU vector never reaches the kernel's wrapper (``takes_kernel``);
    handed one, the wrapper raises rather than compute it another way."""
    ar, keep, x, d, b, inv = (torch.ones(8) for _ in range(6))
    args = (ar, keep, x, d, b, inv, 0.5, 0.25) if step == "recurrence_step" else (ar, keep, x, b, inv, 2.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(TCS, step)(*args)


def on(device, dtype):
    """A stand-in vector: the path rule reads only its device and dtype."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("kind,device,dtype,takes", [
    ("hmg_global", "cuda:0", torch.float32, True),
    ("hmg_global", "cuda:0", torch.float64, True),
    ("local_smoothing", "cuda:0", torch.float32, True),
    ("hmg_global", "cuda:0", torch.bfloat16, False),     # bfloat16 levels
    ("hmg_global", "cpu", torch.float32, False),
    ("local_smoothing", "cpu", torch.float64, False),
    ("no_split", "cuda:0", torch.float32, False),         # gather engine, Stokes
])
def test_the_path_rule(kind, device, dtype, takes):
    if kind == "no_split":
        op = SimpleNamespace(vmult=lambda v: v)
    else:
        op = port_level(kind, torch.float64)[0]
    assert TC.takes_kernel(op, on(device, dtype)) is takes
