"""% of the barotropic stage's least time over all members (``counts/barotropic.py`` at
the data sheet's peaks, times the members) over its device time a step: the kernels
whose name holds ``subcycle_kernel`` (the member axis; layer: kernels)."""

from perfbench.lib.readers import roofline

STAGE, PATTERN = "barotropic", "subcycle_kernel"


def read(run, cell):
    return roofline(run, cell.config, STAGE, PATTERN)
