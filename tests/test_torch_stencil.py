"""The port's patch stencil: plain version against the TPU kernel, wrapper rules.

On the CPU the wrapper ``patch_stencil`` takes the plain PyTorch version;
that version must match the JAX package's Pallas kernel
(``patch_stencil_pallas`` in interpret mode) at S in {9, 17} to the
tolerance of tests/test_pallas_stencil.py, and the reference tensordot
chain in float64.  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.ops import pallas_stencil as jps
from dealii_multigrid_tpu_torch.ops import patch_stencil as ps


def inputs(S, NP, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((NP, S**3)),
        rng.standard_normal((S, S)),
        rng.standard_normal((S, S)),
        rng.standard_normal(NP),
    )


def jax_reference(xp, KS, MS, pscale, S):
    up = xp.reshape(-1, S, S, S)

    def ax(u, mat, axis):
        return jnp.moveaxis(
            jnp.tensordot(u, mat, axes=([axis], [1]),
                          precision=jax.lax.Precision.HIGHEST), -1, axis)

    kx = ax(ax(ax(up, KS, 1), MS, 2), MS, 3)
    ky = ax(ax(ax(up, MS, 1), KS, 2), MS, 3)
    kz = ax(ax(ax(up, MS, 1), MS, 2), KS, 3)
    return ((kx + ky + kz) * pscale[:, None, None, None]).reshape(xp.shape)


@pytest.mark.skipif(not jps.HAVE_PALLAS, reason="pallas unavailable")
@pytest.mark.parametrize("S,NP", [(9, 4), (17, 3)])
def test_plain_stencil_matches_pallas_kernel(S, NP):
    xp, KS, MS, sc = inputs(S, NP)
    want = np.asarray(jps.patch_stencil_pallas(
        *(jnp.asarray(a, jnp.float32) for a in (xp, KS, MS, sc)), S, interpret=True
    ))
    got = ps.patch_stencil(*(torch.as_tensor(a, dtype=torch.float32) for a in (xp, KS, MS, sc)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4 * np.abs(want).max())


@pytest.mark.parametrize("S,NP", [(9, 5), (17, 2), (33, 1)])
def test_plain_stencil_matches_jax_reference_float64(S, NP):
    xp, KS, MS, sc = inputs(S, NP, seed=1)
    want = np.asarray(jax_reference(*(jnp.asarray(a) for a in (xp, KS, MS, sc)), S))
    got = ps.patch_stencil_reference(*(torch.as_tensor(a) for a in (xp, KS, MS, sc)))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_wrapper_takes_plain_path_on_cpu_without_counting():
    args = [torch.as_tensor(a) for a in inputs(9, 3)]
    before = ps.launches.count
    out = ps.patch_stencil(*args)
    assert torch.equal(out, ps.patch_stencil_reference(*args))
    assert ps.launches.count == before


@pytest.mark.parametrize(
    "bad",
    ["rows", "KS", "pscale", "dtype_mix", "int", "noncontiguous"],
)
def test_wrapper_rejects_bad_inputs(bad):
    xp, KS, MS, sc = (torch.as_tensor(a) for a in inputs(9, 2))
    if bad == "rows":
        xp = xp[:, :-1]
    elif bad == "KS":
        KS = KS[:, :-1]
    elif bad == "pscale":
        sc = sc[:1]
    elif bad == "dtype_mix":
        MS = MS.float()
    elif bad == "noncontiguous":
        KS = KS.T
    else:
        xp, KS, MS, sc = (t.to(torch.int64) for t in (xp, KS, MS, sc))
    with pytest.raises(ValueError):
        ps.patch_stencil(xp, KS, MS, sc)


def test_wrapper_refuses_other_devices():
    xp, KS, MS, sc = (torch.as_tensor(a).to("meta") for a in inputs(9, 2))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ps.patch_stencil(xp, KS, MS, sc)


def test_kernel_source_names_the_tpu_kernel_it_replaces():
    with open(ps.SOURCE) as f:
        src = f.read()
    assert "dealii_multigrid_tpu/ops/pallas_stencil.py" in src
    assert "sm_90a" in " ".join(ps.NVCC_FLAGS)
