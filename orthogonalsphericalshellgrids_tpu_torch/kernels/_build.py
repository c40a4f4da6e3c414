"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at the first
CUDA use (never at import), goes into ``_build/`` inside the package, and is redone
whenever a source, header or flag changes (the library name carries their hash). A
failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["library", "build_seconds"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (each returns cudaGetLastError()).
_SIGNATURES = {
    "osg_halo_fill": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "osg_halo_fill_copy": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "osg_barotropic": [_P] * 10 + [_I] * 6 + [_P],
    "osg_momentum": [_P, _P, _P, _P, _P, _I, _I, _P],
    "osg_tracer_adv": [_P, _P, _P, _P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
_build_seconds = None


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH); "
                           "the CUDA kernels cannot be built")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    deps = srcs + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in deps:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def _compile(srcs, out):
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, _build_seconds
    with _lock:
        if _lib is None:
            srcs, digest = _sources()
            out = BUILD_DIR / f"libosg_kernels_{digest}.so"
            _build_seconds = _compile(srcs, out) if not out.exists() else 0.0
            lib = ctypes.CDLL(str(out))
            for name, argtypes in _SIGNATURES.items():
                for suffix in ("f32", "f64"):
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_seconds():
    """Seconds the nvcc build took in this process (0.0 when it was cached);
    None before the first ``library()`` call."""
    return _build_seconds
