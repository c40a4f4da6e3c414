"""Kernel launches a step of the whole ensemble over the window
(``kernels.launch_counts``, graph replays counted as their captures; layer: kernel
wrappers)."""

from perfbench.lib.readers import launches_per_step


def read(run, cell):
    return launches_per_step(run)
