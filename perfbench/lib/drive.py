"""What the drivers of ``perfbench/drivers/`` share.

A traffic mix names its ``driver``: the file ``drivers/<driver>.py``, whose
``run(ctx)`` builds the program, warms up every shape it uses before the window,
drives the mix for the window, keeps the program's states that the check compares (as
host copies) and returns a plain dict (``run``) for the check and the metric readers:
``setup_s``, ``window_s``, ``steps``, ``sim_seconds``, ``members``,
``memory_peak_bytes``, ``launches``, ``capture_s``, ``checks`` (``lib/check.py``) and,
with ``--trace 1``, ``trace``. A ``--trace 1`` run traces a window of
``min(seconds, trace_seconds)``.
"""

from __future__ import annotations

import time

from . import scenario


def window(ctx):
    """The window's seconds: ``--seconds``, or the mix's ``trace_seconds`` when traced."""
    return min(ctx.seconds, ctx.traffic["trace_seconds"]) if ctx.trace else ctx.seconds


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launches():
    """The kernel wrappers' launch counts so far (``kernels.launch_counts``)."""
    from orthogonalsphericalshellgrids_tpu_torch import kernels

    return kernels.launch_counts()


def diff(after, before):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


def peak(device):
    """The card's peak of allocated memory in this process (0 on the CPU)."""
    import torch

    return (int(torch.cuda.max_memory_allocated(device))
            if torch.device(device).type == "cuda" else 0)


def marker(ctx):
    """``program.build``'s ``mark``: the set-up's phases, on the card's clock."""
    def mark(name):
        sync(ctx.device)
        ctx.marks.append((name, time.time()))

    return mark


def pick(seed, n, salt=0):
    """A whole number in [0, n) drawn from the seed (``salt`` draws another)."""
    return int(scenario.rng_of(seed, (1 << 40) + salt).integers(0, 1 << 30)) % max(1, n)


def capture_seconds(model):
    """The seconds of the model's graph captures (``utils/graph.py``), None before any."""
    from orthogonalsphericalshellgrids_tpu_torch.utils import graph

    got = [b.capture_seconds for b in graph.blocks(model).values()
           if b.capture_seconds is not None]
    return sum(got) if got else None
