"""% of the vertical stage's least time as the implicit configurations run it
(``counts/vertical.py`` at the data sheet's peaks: advection, the equation of state,
the pressure; no diffusion) over its device time a step: the kernels whose name holds
``vertical_kernel`` (layer: kernels)."""

from perfbench.lib.readers import roofline

STAGE, PATTERN = "vertical", "vertical_kernel"


def read(run, cell):
    return roofline(run, cell.config, STAGE, PATTERN)
