"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the traced window,
reduced to what the per-layer metrics and the breakdown read.

``summary`` returns plain numbers:
``busy_s`` (the union of device activity: kernels, copies and fills), ``window_s``,
``kernels`` (device seconds by kernel name), ``device_ops`` (the ten that took most)
and ``idle_gaps`` (the ten longest gaps between device activity, each named by the
host operation that overlaps it most, the shortest on a tie, or, where none covers
half of it, as outside torch after the host operation that ended last before it).
"""

from __future__ import annotations

import numpy as np


def profiler():
    """A started ``torch.profiler`` of the host and the card."""
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def _ns(e, what):
    fn = getattr(e, f"{what}_ns", None)
    return fn() if fn is not None else getattr(e, f"{what}_us")() * 1000


def _events(prof):
    """(device events, host events) as lists of (start_ns, end_ns, name)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        span = (start, start + _ns(e, "duration"), e.name())
        if e.device_type() == cuda:
            kind = getattr(e, "activity_type", None)
            if kind is None or "annotation" not in str(kind()).lower():
                dev.append(span)
        else:
            host.append(span)
    return dev, host


def _union(spans):
    """The merged intervals of ``spans`` (sorted (start, end) pairs)."""
    merged = []
    for a, b, _ in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summary(prof, window_s):
    """The reduced trace of the stopped profiler ``prof`` over a window of
    ``window_s`` seconds (see the module docstring)."""
    dev, host = _events(prof)
    kernels = {}
    for a, b, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-9
    merged = _union(dev)
    busy = sum(b - a for a, b in merged) * 1e-9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    idle = []
    if host:
        hs = np.array([h[0] for h in host], dtype=np.int64)
        he = np.array([h[1] for h in host], dtype=np.int64)
        for length, a, b in gaps:
            overlap = np.minimum(he, b) - np.maximum(hs, a)
            best = np.flatnonzero(overlap == overlap.max())
            k = best[np.argmin((he - hs)[best])]
            if 2 * overlap[k] >= length:
                name = host[k][2]
            else:  # no torch operation covers the gap: Python or a library's own code
                before = np.flatnonzero(he <= b)
                name = "outside torch, after " + (
                    host[before[np.argmax(he[before])]][2] if before.size else "the start")
            idle.append([name, length * 1e-9])
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=float(window_s), kernels=kernels,
                device_ops=[[name, s] for name, s in ops], idle_gaps=idle)


def kernel_seconds(trace, pattern):
    """Device seconds of the kernels whose name holds ``pattern``; None when no
    kernel of the trace does."""
    hits = [s for name, s in trace["kernels"].items() if pattern in name]
    return sum(hits) if hits else None
