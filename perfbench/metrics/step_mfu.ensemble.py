"""% of the ensemble step's least time (``counts/step.py`` at the data sheet's peaks,
times the members) over the traced window's time a step (layer: step)."""

from perfbench.lib.readers import step_mfu


def read(run, cell):
    return step_mfu(run, cell.config)
