"""ctypes bridge to the native host-side mesh kernels (repo-root native/).

The port compiles its own copy of the library from the sources in the
repo-root ``native/`` directory into the package's ``_build/`` directory
(``g++ -O3 -fPIC``, no host-specific ``-march``, so the library runs on
whatever host builds it) and never writes into ``native/``.  Every caller
falls back to the vectorised-NumPy implementation when no compiler is
available, so the package works without one.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_LIB = None
_TRIED = False


def _native_dir() -> str:
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "..", "native")
    )


def _build_dir() -> str:
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "_build"))


def _build(srcs: list[str]) -> str | None:
    """Compile ``srcs`` into _build/ (named by content hash); path or None."""
    h = hashlib.sha1()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    out = os.path.join(_build_dir(), f"libmgtpu_native_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run(
            [cxx, "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp, *srcs],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, out)  # atomic: a concurrent compile never sees a partial file
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    srcs = sorted(glob.glob(os.path.join(_native_dir(), "*.cc")))
    path = _build(srcs) if srcs else None
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.mgtpu_balance_2to1.restype = ctypes.c_int64
        lib.mgtpu_balance_2to1.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def balance_2to1(level: np.ndarray, anchor: np.ndarray):
    """Native 2:1 corner balance; returns (level, anchor) or None."""
    lib = load()
    if lib is None:
        return None
    lv = np.ascontiguousarray(level, dtype=np.int32)
    an = np.ascontiguousarray(anchor, dtype=np.int64)
    cap = max(len(lv) * 4, 4096)
    for _ in range(8):
        out_lv = np.empty(cap, dtype=np.int32)
        out_an = np.empty((cap, 3), dtype=np.int64)
        m = lib.mgtpu_balance_2to1(
            lv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            an.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(lv),
            out_lv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_an.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap,
        )
        if m <= cap:
            return out_lv[:m].copy(), out_an[:m].copy()
        cap = int(m * 1.2)
    return None


def _bind_unique(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_unique_bound", False):
        return
    lib.mgtpu_unique_inverse_i64.restype = ctypes.c_int64
    lib.mgtpu_unique_inverse_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib._unique_bound = True


def unique_inverse(keys: np.ndarray):
    """np.unique(keys, return_index=True, return_inverse=True) for int64 keys
    via the native radix kernel (~10x NumPy's sort-based unique on the
    one-core host).  Returns (first, inverse): ``first`` = original index of
    each unique key (key-ascending), ``inverse`` = group id per input.
    Falls back to NumPy when the library is unavailable."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = load()
    if lib is None or keys.min(initial=0) < 0:
        _, first, inverse = np.unique(keys, return_index=True, return_inverse=True)
        return first, inverse
    _bind_unique(lib)
    n = len(keys)
    inverse = np.empty(n, dtype=np.int64)
    first = np.empty(n, dtype=np.int64)
    g = lib.mgtpu_unique_inverse_i64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return first[:g].copy(), inverse


def _bind_dofs(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_dofs_bound", False):
        return
    lib.mgtpu_distribute_dofs.restype = ctypes.c_int64
    lib.mgtpu_distribute_dofs.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # level
        ctypes.POINTER(ctypes.c_int64),   # anchor
        ctypes.c_int64,                   # n
        ctypes.c_int32,                   # degree
        ctypes.c_int32,                   # max level
        ctypes.POINTER(ctypes.c_double),  # gauss-lobatto points
        ctypes.c_double,                  # lower
        ctypes.c_double,                  # upper
        ctypes.POINTER(ctypes.c_int32),   # cell_dofs out
        ctypes.POINTER(ctypes.c_double),  # points out
        ctypes.POINTER(ctypes.c_uint8),   # boundary out
    ]
    lib.mgtpu_argsort_i64.restype = None
    lib.mgtpu_argsort_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib._dofs_bound = True


def distribute_dofs_native(level, anchor, degree, max_level, gl, lower, upper):
    """Fused 3D DoF enumeration (native/dofs.cc); returns
    (n_dofs, cell_dofs [n, nloc] i32, points [n_dofs, 3] f64,
    boundary [n_dofs] bool) or None when the library is unavailable or the
    packed key would overflow 63 bits (caller falls back to NumPy)."""
    lib = load()
    if lib is None:
        return None
    _bind_dofs(lib)
    lv = np.ascontiguousarray(level, dtype=np.int32)
    an = np.ascontiguousarray(anchor, dtype=np.int64)
    glc = np.ascontiguousarray(gl, dtype=np.float64)
    n = len(lv)
    nloc = (degree + 1) ** 3
    cell_dofs = np.empty(n * nloc, dtype=np.int32)
    points = np.empty((n * nloc, 3), dtype=np.float64)
    boundary = np.empty(n * nloc, dtype=np.uint8)
    nd = lib.mgtpu_distribute_dofs(
        lv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        an.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        degree,
        max_level,
        glc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lower,
        upper,
        cell_dofs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        boundary.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if nd < 0:
        return None
    # views, not copies: new physical memory costs ~9 s/GB on this host and
    # the unwritten tail of the capacity buffers was never touched
    return (
        int(nd),
        cell_dofs.reshape(n, nloc),
        points[:nd],
        boundary[:nd].view(bool),
    )


def _bind_covering(lib: ctypes.CDLL) -> None:
    if getattr(lib, "_covering_bound", False):
        return
    lib.mgtpu_covering_cell_level.restype = None
    lib.mgtpu_covering_cell_level.argtypes = [
        ctypes.POINTER(ctypes.c_int64),   # anchors [n, 3]
        ctypes.c_int64,                   # n
        ctypes.c_int32,                   # query_level
        ctypes.c_int32,                   # top (max search level)
        ctypes.POINTER(ctypes.c_uint64),  # per-level sorted codes, concat
        ctypes.POINTER(ctypes.c_int64),   # offsets [n_levels + 1]
        ctypes.c_int32,                   # n_levels
        ctypes.POINTER(ctypes.c_int32),   # out [n]
    ]
    lib._covering_bound = True


def covering_cell_level_native(anchors, query_level, top, codes, offs):
    """Fused covering-cell query (native/covering.cc): one Morton encode per
    query + a binary search per candidate level, replacing a bit-spread pass
    per (level x batch) on the NumPy path.  Returns int32 levels (or -1), or
    None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    _bind_covering(lib)
    an = np.ascontiguousarray(anchors, dtype=np.int64)
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    out = np.empty(len(an), dtype=np.int32)
    lib.mgtpu_covering_cell_level(
        an.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(an),
        int(query_level),
        int(top),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offs) - 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def argsort_i64(keys: np.ndarray) -> np.ndarray:
    """Stable radix argsort for non-negative int64 keys (native), with a
    NumPy fallback."""
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = load()
    if lib is None or (len(keys) and keys.min() < 0):
        return np.argsort(keys, kind="stable")
    _bind_dofs(lib)
    order = np.empty(len(keys), dtype=np.int64)
    lib.mgtpu_argsort_i64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(keys),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order
