"""What the metric readers of ``perfbench/metrics/`` share: the reductions of a run
(the drivers' dict) to numbers, and the card's published peaks.

A reader returns None where its run has nothing to read (no trace, no kernel of its
pattern, no write), and the harness then leaves the metric out of the line; a share
of a roofline or of a peak is never 0 for want of a reading.
"""

from __future__ import annotations

from . import cells
from .trace import kernel_seconds

# NVIDIA H100 SXM data sheet, dense: float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
YEAR_S = 365.0 * 86400.0


def sypd(run):
    """Simulated years per wall-clock day: the simulated seconds of every step in the
    window (of every member, in an ensemble) over the window's seconds, / 365."""
    return (run["sim_seconds"] / YEAR_S) / (run["window_s"] / 86400.0)


def least_seconds(stage, cfg):
    """The least time of ``stage`` at ``cfg``: the larger of its operations at the
    peak FLOP rate and its bytes at the peak bandwidth."""
    ops, nbytes = cells.stage_count(stage, cfg)
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _trace(run):
    """The run's device trace; None where it saw no device activity (a run on the
    CPU), so that no device metric is read from it."""
    t = run.get("trace")
    return t if t and t["busy_s"] > 0 else None


def idle_share(run):
    """% of the traced window in which the card ran nothing."""
    t = _trace(run)
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None


def device_ms_per_step(run):
    """ms of device activity (their union) a step (of every member) over the traced
    window."""
    t = _trace(run)
    return 1e3 * t["busy_s"] / run["steps"] if t and run["steps"] else None


def launches_per_step(run):
    """The kernel wrappers' launches in the window a step (``kernels.launch_counts``)."""
    n = sum(run.get("launches", {}).values())
    return n / run["steps"] if n and run["steps"] else None


def roofline(run, cfg, stage, pattern):
    """% of the stage's least time (of every member) over its device time a step: the
    kernels whose name holds ``pattern``; None when the trace holds none."""
    t = _trace(run)
    if not t or not run["steps"]:
        return None
    seconds = kernel_seconds(t, pattern)
    if not seconds:
        return None
    return 100.0 * run["members"] * least_seconds(stage, cfg) / (seconds / run["steps"])


def step_mfu(run, cfg):
    """% of the whole step's least time (of every member) over the traced window's
    time a step."""
    if not _trace(run) or not run["steps"]:
        return None
    return 100.0 * run["members"] * least_seconds("step", cfg) / (run["window_s"] / run["steps"])
