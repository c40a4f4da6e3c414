"""Profiling and timing: a ``torch.profiler`` trace, CUDA-event step timing, the
timer and the card line that every measurement script uses (``time_ms``,
``smi_line``), and the card's measured ceilings (HBM stream rate, FMA rate).

Counterpart: ``orthogonalsphericalshellgrids_tpu/utils/profiling.py`` (``trace``,
``device_sync``, ``time_steps``, ``stream_probe_gbps``) plus ``fma_ceiling`` of
``benchmarks/weno_sol.py:215-236``. The JAX package times differentially between two
scan lengths and synchronises by a scalar fetch because its remote TPU backend did not
wait in ``block_until_ready``; CUDA events on the stream need neither, so
``scan_time_diff`` and the scalar-fetch barrier are not ported.

Each probe runs as one hand-written kernel (``kernels/probes.py``), where XLA fuses
the JAX package's scan bodies. On CPU tensors (``device="cpu"``) the probes time
the plain versions with the host clock: a number about the CPU, never about a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time
import warnings

import torch

from ..kernels import probes

__all__ = ["trace", "device_sync", "time_steps", "stream_probe_gbps", "fma_ceiling",
           "time_ms", "smi_line", "host_syncs"]


@contextlib.contextmanager
def trace(logdir: str = "osg_trace"):
    """``torch.profiler`` over the block (CPU activity, and CUDA where a card is
    present); yields the profiler and writes ``<logdir>/trace.json`` (Chrome trace
    format) when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def host_syncs():
    """Count the host's waits for the card inside the block: torch's sync debug mode
    warns at each synchronizing CUDA call (a copy to the host, ``.item()``,
    ``float(tensor)``, a blocking copy from the host), and the yielded function
    returns the count so far. Needs a card."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield lambda: sum("synchronizing" in str(w.message) for w in rec)
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def device_sync(tree):
    """Wait for the work queued on every CUDA device that holds a tensor of ``tree``
    (tensors, dataclasses, sequences, dicts); a no-op for CPU tensors. Returns
    ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def time_ms(fn, n=20, reps=5, warm=3, device="cuda", ahead=False):
    """Milliseconds per call of ``fn``: ``n`` back-to-back calls a window, the median
    of ``reps`` windows, after ``warm`` calls. CUDA events around each window on a
    card (a call whose host-side enqueue takes longer than its device work, a small
    kernel, is timed at the enqueue rate, unless ``ahead``: then the card first
    spins until the host has enqueued the whole window, so the window times the
    device work alone, and a window the host did not get ahead of is spun again
    longer); the host clock around a finished window on the CPU. The one timer of
    ``chip_smoke.py`` and ``benchmarks/torch_*.py``."""
    on_card = torch.device(device).type == "cuda"
    for _ in range(warm):
        fn()
    if on_card:
        torch.cuda.synchronize(device)
    hold_ms = 0.0
    if on_card and ahead:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        hold_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 0.2
        torch.cuda.synchronize(device)
    times = []
    while len(times) < reps:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if ahead:
                torch.cuda._sleep(int(hold_ms * _cycles_per_ms(device)))
            start.record()
            for _ in range(n):
                fn()
            held = not start.query()
            end.record()
            end.synchronize()
            if ahead and not held:
                hold_ms *= 2.0
                if hold_ms > 5000.0:
                    raise RuntimeError("time_ms: the host never got ahead of the card; "
                                       "does fn wait for it?")
                continue
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        times.append(ms / n)
    times.sort()
    return times[len(times) // 2]


_CYCLES = {}


def _cycles_per_ms(device):
    """Clock cycles per millisecond of ``torch.cuda._sleep`` on ``device``, from one
    timed spin (cached)."""
    key = str(torch.device(device))
    if key not in _CYCLES:
        cycles = 20_000_000
        torch.cuda._sleep(cycles)  # the first call may load the kernel
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _CYCLES[key] = cycles / start.elapsed_time(end)
    return _CYCLES[key]


def smi_line():
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (the first card), for every measurement's
    line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_steps(step_fn, model, state, dt, n=50, warmup=3):
    """Steady-state milliseconds per step of ``step_fn(model, state, dt)`` and the
    state after it: ``warmup`` steps, then CUDA events around ``n`` steps on a card
    (the host clock after the last step on the CPU)."""
    s = state
    for _ in range(warmup):
        s = step_fn(model, s, dt)
    device_sync(s)
    on_card = any(t.is_cuda for t in _tensors(s))
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        s = step_fn(model, s, dt)
    if on_card:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n, s
    return (time.perf_counter() - t0) / n * 1e3, s


def stream_probe_gbps(n=64 * 2**20, n_launches=20, reps=3, device="cuda"):
    """HBM stream rate in GB/s: ``x · 1.000001 + 0.5`` over ``n`` float32 elements,
    one read and one write each (8 B), ``n_launches`` chained launches a window (the
    output of one is the input of the next), the median of ``reps`` windows. 256 MB
    each way at the default ``n``, five times the 50 MB L2."""
    x = torch.arange(n, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    bufs = [x, y]

    def window():
        for k in range(n_launches):
            probes.stream_probe(bufs[k % 2], out=bufs[(k + 1) % 2])

    ms = time_ms(window, n=1, reps=reps, warm=1, device=device)
    return 8 * n * n_launches / (ms * 1e-3) / 1e9


def fma_ceiling(n=8 * 2**20, n_iter=64, reps=3, device="cuda", dtype=torch.float32):
    """FMA rate in TFLOP/s: ``n_iter`` applications of the 8-chain Horner body of
    ``benchmarks/weno_sol.py:fma_ceiling`` (``probes.FMA_FLOPS`` = 264 flops) to each
    of ``n`` elements in one launch, the median of ``reps``."""
    x = torch.full((n,), 0.999, dtype=dtype, device=device)
    ms = time_ms(lambda: probes.fma_ceiling(x, n_iter), n=1, reps=reps, warm=1,
                 device=device)
    return probes.FMA_FLOPS * n * n_iter / (ms * 1e-3) / 1e12
