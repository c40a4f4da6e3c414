"""% of the barotropic stage's least time (``counts/barotropic.py`` at the data sheet's peaks) over
its device time a step: the kernels whose name holds ``subcycle_kernel`` (layer: kernels)."""

from perfbench.lib.readers import roofline

STAGE, PATTERN = "barotropic", "subcycle_kernel"


def read(run, cell):
    return roofline(run, cell.config, STAGE, PATTERN)
