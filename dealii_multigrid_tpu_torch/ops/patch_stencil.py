"""Patch stencil: the sum-factorized Q_p Laplacian on [NP, S^3] patch rows.

``patch_stencil`` is the one entry point.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/patch_stencil.cu`` (built and counted as
ops/kernels.py sets out) or raises; on a CPU tensor it runs
``patch_stencil_reference``, the plain PyTorch tensordot chain of the JAX
package's ``HybridOperator.cell_apply_raw`` patch branch.  The kernel
replaces the TPU kernel
``dealii_multigrid_tpu/ops/pallas_stencil.py::patch_stencil_pallas``.

The kernel contracts KS and MS only inside their band: the caller passes
``band``, the half-width outside which both are zero (``matrix_band`` of the
host matrices, computed once at set-up; p for the assembled degree-p
matrices).  A band narrower than the matrices' gives a wrong result on the
card; the plain version ignores it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

#: the kernel's entry point per dtype (bfloat16: read and written in
#: bfloat16, computed in float32)
_ENTRY = {
    torch.float32: "patch_stencil_f32",
    torch.float64: "patch_stencil_f64",
    torch.bfloat16: "patch_stencil_bf16",
}
#: half-widths the kernel is built for (one template instance each)
BANDS = tuple(range(1, 9))
#: launches of the CUDA kernel that reached the card (ops/kernels.py)
launches = kernels.counter("patch_stencil")


def bind(lib: ctypes.CDLL, path: str) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.patch_stencil_max_band.restype = ctypes.c_int
    lib.patch_stencil_max_band.argtypes = []
    if lib.patch_stencil_max_band() != max(BANDS):
        raise RuntimeError(f"{path} is built for bands up to {lib.patch_stencil_max_band()}")


library = kernels.Library("patch_stencil", bind)
SOURCE = library.source


def matrix_band(*mats) -> int:
    """Largest |i - j| over the nonzeros of the given host matrices."""
    band = 0
    for m in mats:
        i, j = np.nonzero(np.asarray(m))
        if i.size:
            band = max(band, int(np.abs(i - j).max()))
    return band


def patch_stencil_reference(
    xp: torch.Tensor, KS: torch.Tensor, MS: torch.Tensor, pscale: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: [NP, S^3] -> [NP, S^3], the tensordot chain of
    the reference's cell_apply_raw (axis 1 = x, 2 = y, 3 = z)."""
    S = KS.shape[0]
    up = xp.reshape(-1, S, S, S)

    def ax(u, mat, axis):
        return torch.movedim(torch.tensordot(u, mat, dims=([axis], [1])), -1, axis)

    kx = ax(ax(ax(up, KS, 1), MS, 2), MS, 3)
    ky = ax(ax(ax(up, MS, 1), KS, 2), MS, 3)
    kz = ax(ax(ax(up, MS, 1), MS, 2), KS, 3)
    return ((kx + ky + kz) * pscale[:, None, None, None]).reshape(xp.shape)


def _check(xp, KS, MS, pscale, band) -> int:
    if xp.dim() != 2:
        raise ValueError(f"xp must be [NP, S^3], got shape {tuple(xp.shape)}")
    S = KS.shape[0]
    NP = xp.shape[0]
    if KS.shape != (S, S) or MS.shape != (S, S):
        raise ValueError(f"KS, MS must be [S, S]; got {tuple(KS.shape)}, {tuple(MS.shape)}")
    if xp.shape[1] != S**3:
        raise ValueError(f"xp rows hold {xp.shape[1]} values, expected S^3 = {S**3}")
    if pscale.shape != (NP,):
        raise ValueError(f"pscale must be [NP] = [{NP}], got {tuple(pscale.shape)}")
    for name, t in (("KS", KS), ("MS", MS), ("pscale", pscale)):
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
        if t.dtype != xp.dtype:
            raise ValueError(f"{name} is {t.dtype}, xp is {xp.dtype}")
    if xp.dtype not in _ENTRY:
        raise ValueError(f"patch stencil takes float32, float64 or bfloat16, got {xp.dtype}")
    for name, t in (("xp", xp), ("KS", KS), ("MS", MS), ("pscale", pscale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not isinstance(band, int) or band not in BANDS or band >= S:
        raise ValueError(
            f"band must be an int in {BANDS[0]}..{BANDS[-1]} and below S = {S}, got {band!r}"
        )
    return S


def patch_stencil(
    xp: torch.Tensor, KS: torch.Tensor, MS: torch.Tensor, pscale: torch.Tensor, band: int
) -> torch.Tensor:
    """[NP, S^3] patch rows -> pscale * (KS⊗MS⊗MS + MS⊗KS⊗MS + MS⊗MS⊗KS) rows,
    with KS and MS zero outside half-width ``band``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises (there is no fallback)."""
    S = _check(xp, KS, MS, pscale, band)
    if xp.device.type == "cpu":
        return patch_stencil_reference(xp, KS, MS, pscale)
    if xp.device.type != "cuda":
        raise ValueError(f"patch stencil runs on CPU or CUDA tensors, not {xp.device}")
    NP = xp.shape[0]
    if NP == 0:
        return torch.empty_like(xp)
    device = xp.device.index or 0
    lib = library.for_device(device)
    fn = getattr(lib, _ENTRY[xp.dtype])
    out = torch.empty_like(xp)
    err = fn(
        xp.data_ptr(), KS.data_ptr(), MS.data_ptr(), pscale.data_ptr(), out.data_ptr(),
        NP, S, band, device, torch.cuda.current_stream(xp.device).cuda_stream,
    )
    library.check(err, "launch")
    launches.add(xp.dtype)
    return out
