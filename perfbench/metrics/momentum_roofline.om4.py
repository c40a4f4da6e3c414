"""% of the layered momentum stage's least time (``counts/momentum_layered.py`` at the
data sheet's peaks) over its device time a step: the kernels whose name holds
``momentum_kernel`` (layer: kernels)."""

from perfbench.lib.readers import roofline

STAGE, PATTERN = "momentum_layered", "momentum_kernel"


def read(run, cell):
    return roofline(run, cell.config, STAGE, PATTERN)
