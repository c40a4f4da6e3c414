"""Hand-written CUDA kernels of the main path, each beside its plain PyTorch version.

Each wrapper takes the plain version for a tensor on the CPU and launches its kernel
for a tensor on a CUDA device; there is no other route. ``LAUNCHES`` counts kernel
launches per wrapper (a C entry call counts once), so a run can show that it went
through the kernels; ``counting`` also counts the launches of one thread (one shard
of a y-partitioned run stepped in its own thread). A CUDA graph's capture launches
nothing: ``recording`` keeps the launches its wrappers enqueue apart, and
``add_launches`` counts them again at each replay (``utils/graph.py``).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ._build import library

__all__ = ["LAUNCHES", "reset_launch_counts", "launch_counts", "count", "counting",
           "recording", "add_launches"]

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
    calling thread's ``counting`` block, if any; inside a ``recording`` block only in
    its record."""
    record = getattr(_thread, "record", None)
    if record is not None:
        record[name] += 1
        return
    with _lock:
        LAUNCHES[name] += 1
    own = getattr(_thread, "counts", None)
    if own is not None:
        own[name] += 1


def add_launches(counts):
    """Count the launches of ``counts`` (kernel name -> launches) as ``count`` does:
    a replay of a captured graph launches what its capture recorded."""
    with _lock:
        for name, n in counts.items():
            LAUNCHES[name] += n
    own = getattr(_thread, "counts", None)
    if own is not None:
        for name, n in counts.items():
            own[name] += n


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


@contextlib.contextmanager
def recording(record):
    """Inside the block, the calling thread's launches go to ``record`` (a dict with
    the keys of ``LAUNCHES``) and nowhere else: a graph capture enqueues them into
    the graph without launching them."""
    outer = getattr(_thread, "record", None)
    _thread.record = record
    try:
        yield record
    finally:
        _thread.record = outer


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


def output(name, like, out, shape=None):
    """The buffer a launch writes: a new tensor shaped like ``like`` (or ``shape``),
    or ``out``, checked to be contiguous and of that shape, dtype and device (a
    caller that places the result, ``utils/graph.py``'s blocks)."""
    shape = tuple(like.shape) if shape is None else tuple(shape)
    if out is None:
        return torch.empty_like(like) if shape == tuple(like.shape) else \
            torch.empty(shape, dtype=like.dtype, device=like.device)
    if (tuple(out.shape) != shape or out.dtype != like.dtype or out.device != like.device
            or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {like.dtype} tensor of shape "
                         f"{shape} on {like.device}, got {out.dtype} {tuple(out.shape)} "
                         f"on {out.device}")
    return out


def placed(name, result, out):
    """``result`` (a plain version's) written into ``out``, checked as ``output``
    checks it, when one is given."""
    return result if out is None else output(name, result, out).copy_(result)


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
