"""The port's patch stencil: plain version against the TPU kernel, wrapper rules.

On the CPU the wrapper ``patch_stencil`` takes the plain PyTorch version;
that version must match the JAX package's Pallas kernel
(``patch_stencil_pallas`` in interpret mode) at S in {9, 17} to the
tolerance of tests/test_pallas_stencil.py, and the reference tensordot
chain in float64.  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py).  The inputs here are dense, so
the band passed is the widest the wrapper takes; the plain version ignores it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_multigrid_tpu.ops import pallas_stencil as jps
from dealii_multigrid_tpu_torch.ops import kernels, patch_stencil as ps, tensor
from dealii_multigrid_tpu_torch.ops.hybrid_format import _assembled_1d


def dense_band(S):
    return min(S - 1, ps.BANDS[-1])


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
    got = ps.patch_stencil(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (xp, KS, MS, sc)), dense_band(S)
    )
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
    out = ps.patch_stencil(*args, dense_band(9))
    assert torch.equal(out, ps.patch_stencil_reference(*args))
    assert ps.launches.count == before


@pytest.mark.parametrize("band", ps.BANDS)
def test_wrapper_plain_path_ignores_band(band):
    """On the CPU every accepted band gives exactly the plain version and
    counts no launch."""
    args = [torch.as_tensor(a) for a in inputs(17, 2, seed=band)]
    before = ps.launches.count
    out = ps.patch_stencil(*args, band)
    assert torch.equal(out, ps.patch_stencil_reference(*args))
    assert ps.launches.count == before


@pytest.mark.parametrize("band", [-1, 0, 9, 33, 40, 2.0, None])
def test_wrapper_rejects_bad_band(band):
    """Negative, zero, not below S, past the built instances, not an int."""
    xp, KS, MS, sc = (torch.as_tensor(a) for a in inputs(33, 1))
    with pytest.raises(ValueError, match="band"):
        ps.patch_stencil(xp, KS, MS, sc, band)


def test_wrapper_rejects_band_not_below_S():
    xp, KS, MS, sc = (torch.as_tensor(a) for a in inputs(5, 1))
    for band in (5, 6):
        with pytest.raises(ValueError, match="band"):
            ps.patch_stencil(xp, KS, MS, sc, band)
    ps.patch_stencil(xp, KS, MS, sc, 4)


@pytest.mark.parametrize("p", range(1, 9))
def test_assembled_matrices_have_band_p(p):
    S = 8 * p + 1
    KS = _assembled_1d(tensor.stiffness_matrix_1d(p), 8, p)
    MS = _assembled_1d(tensor.mass_matrix_1d(p), 8, p)
    assert ps.matrix_band(KS, MS) == ps.matrix_band(KS) == ps.matrix_band(MS) == p
    assert KS.shape == (S, S)


def test_matrix_band_of_random_banded_matrices():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((12, 12))
    i, j = np.indices(a.shape)
    assert ps.matrix_band(np.where(abs(i - j) <= 3, a, 0.0)) == 3
    assert ps.matrix_band(np.where(abs(i - j) <= 3, a, 0.0), np.eye(12)) == 3
    assert ps.matrix_band(np.eye(12)) == 0
    assert ps.matrix_band(a) == 11


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
        ps.patch_stencil(xp, KS, MS, sc, dense_band(9))


def test_wrapper_refuses_other_devices():
    xp, KS, MS, sc = (torch.as_tensor(a).to("meta") for a in inputs(9, 2))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ps.patch_stencil(xp, KS, MS, sc, dense_band(9))


def test_kernel_source_names_the_tpu_kernel_it_replaces():
    with open(ps.SOURCE) as f:
        src = f.read()
    assert "dealii_multigrid_tpu/ops/pallas_stencil.py" in src
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)


def test_library_tag_changes_with_the_source_and_the_flags(tmp_path):
    """The built library's path carries the SHA-1 of the source and the
    nvcc flags: an unchanged source loads the library built before, a
    changed source or flag builds anew (so the card never runs a stale
    kernel)."""
    same = tmp_path / "same.cu"
    same.write_bytes(open(ps.SOURCE, "rb").read())
    changed = tmp_path / "changed.cu"
    changed.write_bytes(open(ps.SOURCE, "rb").read() + b"// changed\n")
    here = ps.library.target()
    assert kernels.source_tag(ps.SOURCE) in here and here.startswith(kernels.BUILD_DIR)
    assert os.path.basename(here).startswith("libpatch_stencil_")

    def library(source, flags=kernels.NVCC_FLAGS):
        return kernels.Library("patch_stencil", ps.bind, str(source), flags)

    assert library(same).target() == here
    assert library(changed).target() != here
    assert library(same, kernels.NVCC_FLAGS + ("-lineinfo",)).target() != here


def test_compare_stencil_reads_each_checkouts_flags_and_needs_a_card(monkeypatch, capsys):
    """tools/compare_stencil.py builds another checkout's kernel with that
    checkout's own NVCC_FLAGS, and without a card it exits 2 before it
    builds anything."""
    from dealii_multigrid_tpu_torch.tools import compare_stencil

    root = os.path.dirname(os.path.dirname(os.path.abspath(ps.SOURCE)))
    assert compare_stencil.checkout_flags(os.path.dirname(root)) == kernels.NVCC_FLAGS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["compare_stencil", os.path.dirname(root)])
    assert compare_stencil.main() == 2
    assert "no CUDA card" in capsys.readouterr().err
