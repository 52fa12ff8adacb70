"""Patch stencil: the sum-factorized Q_p Laplacian on [NP, S^3] patch rows.

``patch_stencil`` is the one entry point.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/patch_stencil.cu`` (built with nvcc for
sm_90a at first use into the package's ``_build/`` directory and loaded
with ctypes) or raises; on a CPU tensor it runs ``patch_stencil_reference``,
the plain PyTorch tensordot chain of the JAX package's
``HybridOperator.cell_apply_raw`` patch branch.  The kernel replaces the TPU
kernel ``dealii_multigrid_tpu/ops/pallas_stencil.py::patch_stencil_pallas``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "patch_stencil.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class LaunchCounter:
    """Number of kernel launches; the wrapper adds one per launch."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


#: launches of the CUDA kernel (the plain CPU path does not count)
launches = LaunchCounter()


class _Library:
    """The compiled kernel library (built once per process, on first use)."""

    def __init__(self) -> None:
        self.lib: ctypes.CDLL | None = None
        self.path: str | None = None
        self.build_seconds = 0.0
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self._load()
        return self.lib

    def _nvcc(self) -> str:
        cand = shutil.which("nvcc")
        if cand is None:
            home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
            cand = os.path.join(home, "bin", "nvcc")
        if not os.path.exists(cand):
            raise RuntimeError(
                "nvcc not found (PATH or $CUDA_HOME/bin): the patch-stencil "
                "kernel is built from csrc/patch_stencil.cu at first use"
            )
        return cand

    def _load(self) -> None:
        with open(SOURCE, "rb") as f:
            tag = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        path = os.path.join(BUILD_DIR, f"libpatch_stencil_{tag}.so")
        t0 = time.perf_counter()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [self._nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                    capture_output=True, text=True, timeout=600,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) on {SOURCE}:\n{self.build_log}"
                    )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        for name in ("patch_stencil_f32", "patch_stencil_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.patch_stencil_error_string.restype = ctypes.c_char_p
        lib.patch_stencil_error_string.argtypes = [ctypes.c_int]
        self.build_seconds = time.perf_counter() - t0
        self.path = path
        self.lib = lib


library = _Library()


def build() -> float:
    """Build (or load) the kernel library now; returns the seconds it took."""
    library.get()
    return library.build_seconds


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


def _check(xp, KS, MS, pscale) -> int:
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
    if xp.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"patch stencil takes float32 or float64, got {xp.dtype}")
    for name, t in (("xp", xp), ("KS", KS), ("MS", MS), ("pscale", pscale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return S


def patch_stencil(
    xp: torch.Tensor, KS: torch.Tensor, MS: torch.Tensor, pscale: torch.Tensor
) -> torch.Tensor:
    """[NP, S^3] patch rows -> pscale * (KS⊗MS⊗MS + MS⊗KS⊗MS + MS⊗MS⊗KS) rows.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises (there is no fallback)."""
    S = _check(xp, KS, MS, pscale)
    if xp.device.type == "cpu":
        return patch_stencil_reference(xp, KS, MS, pscale)
    if xp.device.type != "cuda":
        raise ValueError(f"patch stencil runs on CPU or CUDA tensors, not {xp.device}")
    NP = xp.shape[0]
    if NP == 0:
        return torch.empty_like(xp)
    lib = library.get()
    fn = lib.patch_stencil_f32 if xp.dtype == torch.float32 else lib.patch_stencil_f64
    C = torch.empty_like(xp)
    D = torch.empty_like(xp)
    out = torch.empty_like(xp)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = fn(
        xp.data_ptr(), KS.data_ptr(), MS.data_ptr(), pscale.data_ptr(),
        C.data_ptr(), D.data_ptr(), out.data_ptr(),
        NP, S, xp.device.index or 0, stream,
    )
    if err != 0:
        msg = lib.patch_stencil_error_string(err).decode()
        raise RuntimeError(f"patch stencil kernel launch failed: {msg} (code {err})")
    launches.count += 1
    return out
