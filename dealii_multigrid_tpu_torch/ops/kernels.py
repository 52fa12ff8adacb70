"""The hand-written CUDA kernels' build and launch counts.

``Library`` builds ``csrc/<name>.cu`` with nvcc (``NVCC_FLAGS``, sm_90a) at
first use into ``_build/lib<name>_<source_tag>.so``.  A kernel's wrapper
adds one to its counter (``counter(name)``) per launch; the counters hold
the launches that reached the card, each CUDA graph replay's included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from contextlib import contextmanager
from typing import Callable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def source_tag(source: str, flags: tuple = NVCC_FLAGS) -> str:
    """12 hex digits of the SHA-1 of the source and the nvcc flags."""
    with open(source, "rb") as f:
        return hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:12]


class Library:
    """A compiled kernel library (built once per process, on first use) of
    ``source`` (``csrc/<name>.cu`` where None) with nvcc ``flags``, into
    BUILD_DIR under ``source_tag``.  ``name`` prefixes its exported
    functions ``<name>_init(device)`` and ``<name>_error_string(code)`` and
    its file; ``bind(lib, path)`` declares its other entry points."""

    def __init__(self, name: str, bind: Callable, source: str | None = None,
                 flags: tuple = NVCC_FLAGS) -> None:
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu") if source is None else source
        self.bind = bind
        self.flags = tuple(flags)
        self.lib: ctypes.CDLL | None = None
        self.path: str | None = None
        self.build_seconds = 0.0
        self.build_log = ""
        self.ready_devices: set[int] = set()

    def build(self) -> float:
        """Build (or load) the library, once; returns the seconds it took."""
        if self.lib is None:
            self._load()
        return self.build_seconds

    def nvcc(self) -> str:
        cand = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
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
                    [self.nvcc(), *self.flags, "-o", tmp, self.source],
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
        for suffix, restype in (("init", ctypes.c_int), ("error_string", ctypes.c_char_p)):
            fn = getattr(lib, f"{self.name}_{suffix}")
            fn.restype, fn.argtypes = restype, [ctypes.c_int]
        self.bind(lib, path)
        self.build_seconds = time.perf_counter() - t0
        self.path = path
        self.lib = lib

    def target(self) -> str:
        """The library's path: a changed source or flag builds anew."""
        return os.path.join(BUILD_DIR, f"lib{self.name}_{source_tag(self.source, self.flags)}.so")

    def for_device(self, device: int) -> ctypes.CDLL:
        """The library, initialised for ``device`` (once per card)."""
        self.build()
        if device not in self.ready_devices:
            self.check(getattr(self.lib, f"{self.name}_init")(device), "initialisation")
            self.ready_devices.add(device)
        return self.lib

    def check(self, err: int, what: str) -> None:
        """Raise naming ``what`` where a call returned a CUDA error code."""
        if err != 0:
            msg = getattr(self.lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} kernel {what} failed: {msg} (code {err})")


class LaunchCounter:
    """Launches of one kernel that reached the card, in all and per dtype
    (one per instance: float32, float64, bfloat16)."""

    def __init__(self) -> None:
        self.per_dtype: dict = {}

    @property
    def count(self) -> int:
        return sum(self.per_dtype.values())

    def reset(self) -> None:
        self.per_dtype = {}

    def add(self, dtype: torch.dtype, n: int = 1) -> None:
        self.per_dtype[dtype] = self.per_dtype.get(dtype, 0) + n


#: every kernel's counter, by name; and the calls the captures recorded
#: since ``reset`` (each capture's eager warm-up launched as many)
COUNTERS: dict[str, LaunchCounter] = {}
RECORDED: dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter())


def counts(counters: dict = COUNTERS) -> dict:
    """{kernel: {dtype: launches}} (no zeros, no kernel without launches)."""
    out = {name: {k: n for k, n in c.per_dtype.items() if n} for name, c in counters.items()}
    return {name: per_dtype for name, per_dtype in out.items() if per_dtype}


def reset() -> None:
    for c in (*COUNTERS.values(), *RECORDED.values()):
        c.reset()


def add(calls: dict, times: int = 1, into: dict = COUNTERS) -> None:
    """``times`` x ``calls`` ({kernel: {dtype: n}}) onto the counters ``into``."""
    for name, per_dtype in calls.items():
        for dtype, n in per_dtype.items():
            into.setdefault(name, LaunchCounter()).add(dtype, times * n)


@contextmanager
def recorded():
    """Around a CUDA graph's capture: yields a dict that it fills on exit
    with the kernel calls made inside, which it takes off the counters."""
    before, calls = counts(), {}
    yield calls
    for name, per_dtype in counts().items():
        was = before.get(name, {})
        diff = {k: n - was.get(k, 0) for k, n in per_dtype.items() if n != was.get(k, 0)}
        if diff:
            calls[name] = diff
    add(calls, -1)
    add(calls, into=RECORDED)
