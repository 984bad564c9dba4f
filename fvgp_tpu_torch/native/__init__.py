"""On-demand-built C++ host runtime (ctypes bindings).

Builds the port's own ``native/structure.cpp`` (a copy of the JAX
package's host source; the port reads nothing of that package) into
``fvgp_tpu_torch/_build/`` on first use (g++ -O3 -fopenmp) and exposes it
through ctypes; every entry point has a numpy fallback, so the framework
works without a toolchain.  :func:`backend` says which of the two runs.
Disable with ``FVGP_TPU_NATIVE=0``.
"""

import ctypes
import os
import subprocess
import uuid
import warnings
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False

_PKG = Path(__file__).resolve().parent.parent
_SRC = Path(__file__).resolve().parent / "structure.cpp"
_BUILD_DIR = _PKG / "_build"


def _build(build_dir=_BUILD_DIR):
    """The library's path in ``build_dir``, compiled there unless a build
    newer than the source exists.  The compiler writes a file of this
    process's own, renamed into place in one step, so processes that start
    together (the ranks of a mesh) never load a partly written library."""
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    so_path = build_dir / "libfvgp_structure.so"
    if so_path.exists() and so_path.stat().st_mtime >= _SRC.stat().st_mtime:
        return so_path
    tmp = build_dir / f".{so_path.name}.{os.getpid()}.{uuid.uuid4().hex}"
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        tmp.unlink(missing_ok=True)
    return so_path


def get_lib():
    """The loaded native library, or None (numpy fallback)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FVGP_TPU_NATIVE", "1") == "0":
        return None
    try:
        so_path = _build()
        lib = ctypes.CDLL(str(so_path))
        lib.morton_codes.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.block_bounds.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.candidate_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64]
        lib.candidate_pairs.restype = ctypes.c_int64
        lib.tile_live.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    except Exception as exc:
        warnings.warn(f"fvgp_tpu_torch native runtime unavailable ({exc}); "
                      f"falling back to numpy.")
        _LIB = None
    return _LIB


def backend():
    """``"native"`` when the C++ runtime is loaded, else ``"numpy"``."""
    return "native" if get_lib() is not None else "numpy"


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def morton_codes(x):
    """Morton codes of x (n, d) — native if available."""
    x = np.ascontiguousarray(x, dtype=np.float64)
    lib = get_lib()
    n, d = x.shape
    if lib is None:
        from ..parallel.ordering import spread_bits
        use = min(d, 8)
        lo = x.min(axis=0)
        span = np.maximum(x.max(axis=0) - lo, 1e-300)
        q = ((x[:, :use] - lo[:use]) / span[:use] * 65535.0).astype(np.uint64)
        code = np.zeros(n, dtype=np.uint64)
        for dim in range(use):
            code |= spread_bits(q[:, dim], use) << np.uint64(dim)
        return code
    out = np.empty(n, dtype=np.uint64)
    lib.morton_codes(_dptr(x), n, d,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def block_bounds(x, block_size):
    x = np.ascontiguousarray(x, dtype=np.float64)
    n, d = x.shape
    nb = -(-n // block_size)
    lib = get_lib()
    if lib is None:
        n_pad = nb * block_size
        xp = np.full((n_pad, d), np.nan)
        xp[:n] = x
        xb = xp.reshape(nb, block_size, d)
        return np.nanmin(xb, axis=1), np.nanmax(xb, axis=1)
    lo = np.empty((nb, d))
    hi = np.empty((nb, d))
    lib.block_bounds(_dptr(x), n, d, block_size, _dptr(lo), _dptr(hi))
    return lo, hi


def candidate_pairs(lo, hi, radius):
    """Upper-triangle block pairs within `radius` box gap — native if
    available, else the vectorized numpy scan."""
    lo = np.ascontiguousarray(lo, dtype=np.float64)
    hi = np.ascontiguousarray(hi, dtype=np.float64)
    nb, d = lo.shape
    lib = get_lib()
    if lib is None:
        gap = np.maximum(lo[None, :, :] - hi[:, None, :],
                         lo[:, None, :] - hi[None, :, :])
        gap = np.maximum(gap, 0.0)
        keep = np.triu(np.sum(gap ** 2, axis=-1) <= radius ** 2)
        rows, cols = np.nonzero(keep)
        return rows.astype(np.int32), cols.astype(np.int32)
    cap = max(nb * 32, 1024)
    while True:
        rows = np.empty(cap, dtype=np.int32)
        cols = np.empty(cap, dtype=np.int32)
        count = lib.candidate_pairs(
            _dptr(lo), _dptr(hi), nb, d, float(radius),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if count <= cap:
            return rows[:count], cols[:count]
        cap = int(count)


def tile_live(x_whitened, rows, cols, block_size, radius):
    """Exact per-tile liveness: True where some point pair of blocks
    (rows[t], cols[t]) lies within `radius` in the whitened coordinates.
    Native (OpenMP, early-exit) if available, else a numpy block loop.
    Sentinel indices (>= nb) come back dead."""
    x = np.ascontiguousarray(x_whitened, dtype=np.float64)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    n, d = x.shape
    nb = -(-n // block_size)
    out = np.zeros(len(rows), dtype=np.uint8)
    lib = get_lib()
    if lib is not None:
        lib.tile_live(_dptr(x), n, d, block_size, 
                      rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      len(rows), float(radius),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.astype(bool)
    r2 = float(radius) ** 2
    for t in range(len(rows)):
        bi, bj = int(rows[t]), int(cols[t])
        if bi >= nb or bj >= nb:
            continue
        a = x[bi * block_size:(bi + 1) * block_size]
        b = x[bj * block_size:(bj + 1) * block_size]
        d2 = np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
        out[t] = bool(np.any(d2 < r2))
    return out.astype(bool)
