"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for ``sm_90a``,
all started together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``. The build runs at the first CUDA use (never at
import), goes into ``_build/`` inside the package, and is redone whenever a source,
header or flag changes (the library name carries their hash). A failed build raises
with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["library", "build_seconds", "standalone"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_int64
_T = ctypes.POINTER(ctypes.c_int64)
# C entry points and their argument types (each returns cudaGetLastError()).
_SIGNATURES = {
    "osg_stream_probe": [_P, _P, _L, _P],
    "osg_fma_ceiling": [_P, _P, _L, _I, _P],
    "osg_weno_probe": [_P, _P, _I, _I, _I, _I, _P],
    "osg_baro_substep_sol": [_P] * 4 + [_I] * 4 + [_P],
    "osg_halo_fill_group": [_T, _I, _P, _I, _P, _P, _P, _P, _T, _T, _I, _P],
    "osg_halo_pack_group": [_T, _I, _P, _I, _P],
    "osg_halo_restore_group": [_T, _I, _P, _I, _P],
    "osg_halo_fill_copy": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "osg_barotropic": [_P] * 10 + [_I] * 10 + [_P],
    "osg_momentum": [_P] * 10 + [_I] * 9 + [_P],
    "osg_tracer_adv": [_P] * 6 + [_I] * 6 + [_P],
    "osg_tracer_adv_members": [_P] * 6 + [_I] * 7 + [_P],
    "osg_tracer_adv_layered": [_P] * 8 + [_I] * 6 + [_L] + [_I] * 2 + [_P],
    "osg_corrector": [_P] + [_I] * 4 + [_L, _I, _L, _I, _I, _P],
    "osg_vertical": [_P] * 10 + [_I] * 14 + [_D] * 5 + [_P],
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


def _run(procs):
    """Wait for every (cmd, Popen); raise with the output of the first that failed."""
    failed = None
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    if failed is not None:
        cmd, rc, err = failed
        raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{err}")


def _compile(srcs, out):
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = out.with_suffix(f".{tag}")
    t0 = time.perf_counter()
    try:
        compiles = [[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(srcs, objs)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True)) for cmd in compiles])
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return time.perf_counter() - t0


def standalone(source, out_dir):
    """The path of a shared library built from one CUDA source outside ``csrc/`` (a
    benchmark's own kernel) with the port's flags and ``csrc/`` on the include path,
    cached in ``out_dir`` by the content of the source, the flags and the headers."""
    source, out_dir = Path(source), Path(out_dir)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    out = out_dir / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o", str(tmp), str(source)]
        try:
            _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                         text=True))])
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


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
