"""ms of device activity a step (the union of kernels, copies and fills over the
traced window, per step; layer: step)."""

from perfbench.lib.readers import device_ms_per_step


def read(run, cell):
    return device_ms_per_step(run)
