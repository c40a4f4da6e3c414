"""ctypes bindings of the native (C++/OpenMP) grid-generation kernels.

Counterpart: ``orthogonalsphericalshellgrids_tpu/grids/native.py``. The repo's
``native/tripolar_gen.cpp`` parallelizes the two per-point loops of the grid build
(the Murray mapping and the metric arcs and areas; the reference notes that host
grid generation "might become slow for sub-kilometer resolution grids",
``src/tripolar_grid.jl:68-71``). This loader compiles it at the first use with
``c++ -O3 -fopenmp -shared -fPIC`` into the port's ``_build/`` (named by a hash of
the source and the flags, written through a temporary file), and never reads or
writes ``native/libtripolar_gen.so``, which the JAX package's loader rebuilds in
place. ``tests/test_torch_grid_options.py`` holds it against the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "build_error", "murray_coords", "metric_arcs", "CALLS"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "tripolar_gen.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

# calls of each native function in this process, so that a run can show which path
# built its grid
CALLS = {"murray_coords": 0, "metric_arcs": 0}

_lock = threading.Lock()
_lib = None
_error = None

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _library_path():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtripolar_gen_{h.hexdigest()[:16]}.so"


def _build(out):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    try:
        for cc in ("c++", "g++"):
            try:
                subprocess.run([cc, *FLAGS, str(SOURCE), "-o", str(tmp)], check=True,
                               capture_output=True, text=True, timeout=300)
            except FileNotFoundError:
                errors.append(f"{cc}: not found")
                continue
            except subprocess.CalledProcessError as e:
                errors.append(f"{cc}: exit {e.returncode}\n{e.stderr}")
                continue
            os.replace(tmp, out)
            return
    finally:
        tmp.unlink(missing_ok=True)
    raise RuntimeError("cannot build native/tripolar_gen.cpp: " + "; ".join(errors))


def _load():
    """The loaded library, built first if needed; None (with ``build_error``) when
    it cannot be built or loaded. Tried once a process."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            out = _library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except Exception as e:  # reported by build_error; the caller decides
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.murray_coords.argtypes = [_D, _D, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_double, ctypes.c_double, _D, _D]
        lib.metric_arcs.argtypes = [_D] * 8 + [ctypes.c_int64] * 5 + [ctypes.c_double] + \
            [_D] * 12
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error():
    """Why the library is not available (None when it is, or before the first try)."""
    return _error


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native grid-generation library is unavailable: "
                           f"{_error}")
    return lib


def murray_coords(lam1d, phi1d, nx, focal_distance, first_pole_longitude):
    """The Murray mapping at one staggered location; (λ2, φ2) of shape (ny, nx)."""
    lib = _lib_or_raise()
    lam1d = np.ascontiguousarray(lam1d, np.float64)
    phi1d = np.ascontiguousarray(phi1d, np.float64)
    ny = len(phi1d)
    lam2 = np.empty((ny, nx))
    phi2 = np.empty((ny, nx))
    lib.murray_coords(lam1d, phi1d, nx, ny, float(focal_distance),
                      float(first_pole_longitude), lam2, phi2)
    CALLS["murray_coords"] += 1
    return lam2, phi2


def metric_arcs(coords, nx, ny, hx, hy, radius):
    """The 12 interior (ny, nx) metric arrays from the halo-inclusive coordinates
    (``coords``: lam_ff, phi_ff, lam_fc, phi_fc, lam_cf, phi_cf, lam_cc, phi_cc)."""
    lib = _lib_or_raise()
    args = [np.ascontiguousarray(coords[k], np.float64) for k in
            ("lam_ff", "phi_ff", "lam_fc", "phi_fc", "lam_cf", "phi_cf", "lam_cc",
             "phi_cc")]
    nxh = args[0].shape[1]
    names = ["dx_cc", "dx_fc", "dx_cf", "dx_ff", "dy_cc", "dy_fc", "dy_cf", "dy_ff",
             "az_cc", "az_fc", "az_cf", "az_ff"]
    outs = [np.empty((ny, nx)) for _ in names]
    lib.metric_arcs(*args, nx, ny, nxh, hx, hy, float(radius), *outs)
    CALLS["metric_arcs"] += 1
    return dict(zip(names, outs))
