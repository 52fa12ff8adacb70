"""Patch stencil: the sum-factorized Q_p Laplacian on [NP, S^3] patch rows.

``patch_stencil`` is the one entry point.  On a CUDA tensor it launches the
hand-written kernel in ``csrc/patch_stencil.cu`` (built with nvcc for
sm_90a at first use into the package's ``_build/`` directory and loaded
with ctypes) or raises; on a CPU tensor it runs ``patch_stencil_reference``,
the plain PyTorch tensordot chain of the JAX package's
``HybridOperator.cell_apply_raw`` patch branch.  The kernel replaces the TPU
kernel ``dealii_multigrid_tpu/ops/pallas_stencil.py::patch_stencil_pallas``.

The kernel contracts KS and MS only inside their band: the caller passes
``band``, the half-width outside which both are zero (``matrix_band`` of the
host matrices, computed once at set-up; p for the assembled degree-p
matrices).  A band narrower than the matrices' gives a wrong result on the
card; the plain version ignores it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "patch_stencil.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
#: the kernel's entry point per dtype (bfloat16: read and written in
#: bfloat16, computed in float32)
_ENTRY = {
    torch.float32: "patch_stencil_f32",
    torch.float64: "patch_stencil_f64",
    torch.bfloat16: "patch_stencil_bf16",
}
#: half-widths the kernel is built for (one template instance each)
BANDS = tuple(range(1, 9))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class LaunchCounter:
    """Number of kernel launches, in all and per dtype (one per instance:
    float32, float64, bfloat16); the wrapper adds one per launch."""

    def __init__(self) -> None:
        self.count = 0
        self.per_dtype: dict = {}

    def reset(self) -> None:
        self.count = 0
        self.per_dtype = {}

    def add(self, dtype: torch.dtype) -> None:
        self.count += 1
        self.per_dtype[dtype] = self.per_dtype.get(dtype, 0) + 1


#: launches of the CUDA kernel (the plain CPU path does not count), made
#: at the call; a call while the stream captures a CUDA graph counts in
#: ``captured`` instead: it launches when the graph replays
#: (``utils.phases.GRAPHS.stencil``)
launches = LaunchCounter()
captured = LaunchCounter()


class _Library:
    """A compiled kernel library (built once per process, on first use) of
    ``source`` with nvcc ``flags``, into BUILD_DIR under ``source_tag``.
    ``name`` prefixes its exported functions ``<name>_init(device)`` and
    ``<name>_error_string(code)`` and its file; ``bind(lib, path)`` declares
    its other entry points."""

    def __init__(self, source: str = SOURCE, flags: tuple = NVCC_FLAGS,
                 name: str = "patch_stencil", bind=None) -> None:
        self.source = source
        self.flags = tuple(flags)
        self.name = name
        self.bind = _bind_stencil if bind is None else bind
        self.lib: ctypes.CDLL | None = None
        self.path: str | None = None
        self.build_seconds = 0.0
        self.build_log = ""
        self.ready_devices: set[int] = set()

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
                f"nvcc not found (PATH or $CUDA_HOME/bin): the {self.name} kernel is "
                f"built from csrc/{os.path.basename(self.source)} at first use"
            )
        return cand

    def _load(self) -> None:
        path = self.target()
        t0 = time.perf_counter()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [self._nvcc(), *self.flags, "-o", tmp, self.source],
                    capture_output=True, text=True, timeout=600,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) on {self.source}:\n{self.build_log}"
                    )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        init = getattr(lib, f"{self.name}_init")
        init.restype = ctypes.c_int
        init.argtypes = [ctypes.c_int]
        err = getattr(lib, f"{self.name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        self.bind(lib, path)
        self.build_seconds = time.perf_counter() - t0
        self.path = path
        self.lib = lib

    def target(self) -> str:
        """The library's path: a changed source or flag builds anew."""
        return os.path.join(BUILD_DIR, f"lib{self.name}_{source_tag(self.source, self.flags)}.so")

    def for_device(self, device: int) -> ctypes.CDLL:
        """The library, initialised for ``device`` (once per card)."""
        lib = self.get()
        if device not in self.ready_devices:
            self.check(getattr(lib, f"{self.name}_init")(device), "initialisation")
            self.ready_devices.add(device)
        return lib

    def check(self, err: int, what: str) -> None:
        """Raise naming ``what`` where a call returned a CUDA error code."""
        if err != 0:
            msg = getattr(self.lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} kernel {what} failed: {msg} (code {err})")


def _bind_stencil(lib: ctypes.CDLL, path: str) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.patch_stencil_max_band.restype = ctypes.c_int
    lib.patch_stencil_max_band.argtypes = []
    if lib.patch_stencil_max_band() != max(BANDS):
        raise RuntimeError(f"{path} is built for bands up to {lib.patch_stencil_max_band()}")


def source_tag(source: str = SOURCE, flags: tuple = NVCC_FLAGS) -> str:
    """12 hex digits of the SHA-1 of the source and the nvcc flags."""
    with open(source, "rb") as f:
        return hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:12]


library = _Library()


def matrix_band(*mats) -> int:
    """Largest |i - j| over the nonzeros of the given host matrices."""
    band = 0
    for m in mats:
        i, j = np.nonzero(np.asarray(m))
        if i.size:
            band = max(band, int(np.abs(i - j).max()))
    return band


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
    (captured if torch.cuda.is_current_stream_capturing() else launches).add(xp.dtype)
    return out
