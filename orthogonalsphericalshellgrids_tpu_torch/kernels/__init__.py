"""Hand-written CUDA kernels of the main path, each beside its plain PyTorch version.

Each wrapper takes the plain version for a tensor on the CPU and launches its kernel
for a tensor on a CUDA device; there is no other route. ``LAUNCHES`` counts kernel
launches per wrapper (a C entry call counts once), so a run can show that it went
through the kernels; ``counting`` also counts the launches of one thread (one shard
of a y-partitioned run stepped in its own thread).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ._build import library

__all__ = ["LAUNCHES", "reset_launch_counts", "launch_counts", "count", "counting"]

LAUNCHES = {"halo_fill": 0, "halo_restore": 0, "halo_fill_copy": 0, "halo_pack": 0,
            "halo_fill_shard": 0, "halo_wrap": 0, "halo_fill_block": 0,
            "halo_pack_block": 0, "barotropic": 0,
            "momentum": 0, "tracer_adv": 0, "vertical": 0, "momentum_layered": 0,
            "tracer_adv_layered": 0, "momentum_closures": 0, "tracer_adv_kappa": 0,
            "tracer_adv_planes": 0, "tracer_adv_members": 0, "vertical_members": 0,
            "momentum_members": 0, "tracer_adv_layered_members": 0, "corrector_members": 0,
            "corrector": 0, "baro_substep_sol": 0, "weno_probe": 0, "stream_probe": 0,
            "fma_ceiling": 0}


_lock = threading.Lock()
_thread = threading.local()


def reset_launch_counts():
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts():
    with _lock:
        return dict(LAUNCHES)


def count(name):
    """Count one launch of kernel ``name``: in ``LAUNCHES`` (under a lock, since the
    shards of one process launch from several threads) and in the counts of the
    calling thread's ``counting`` block, if any."""
    with _lock:
        LAUNCHES[name] += 1
    own = getattr(_thread, "counts", None)
    if own is not None:
        own[name] += 1


@contextlib.contextmanager
def counting(counts):
    """Inside the block, add each launch the calling thread makes to ``counts`` (a
    dict with the keys of ``LAUNCHES``) as well."""
    outer = getattr(_thread, "counts", None)
    _thread.counts = counts
    try:
        yield counts
    finally:
        _thread.counts = outer


def on_cuda(*tensors):
    """True if every tensor is on a CUDA device, False if every one is on the CPU;
    raises on a mix or on another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel operands lie on different CUDA devices")
        return True
    raise ValueError(f"kernel operands must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def check_operands(name, tensors, dtype, shapes):
    """Validate kernel operands: dtype float32/float64, one dtype, contiguous, and
    the expected shapes (``shapes`` maps operand name -> shape)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype must be float32 or float64, got {dtype}")
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in shapes and tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shapes[key])}")


def data_ptr(t):
    """The device address of ``t``, or None (a null pointer) for an absent operand."""
    return None if t is None else t.data_ptr()


def call(entry, dtype, device, *args):
    """Call C entry ``entry`` (``_f32``/``_f64`` by dtype) on the current stream of
    ``device``; raise if it reports a CUDA error."""
    fn = getattr(library(), f"{entry}_{'f32' if dtype == torch.float32 else 'f64'}")
    with torch.cuda.device(device):  # makes the device's context current for the launch
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")
