"""% of the layered tracer stage's least time (``counts/tracer_layered.py`` at the data
sheet's peaks, T and S) over its device time a step: the kernels whose name holds
``tracer_adv_kernel`` (layer: kernels)."""

from perfbench.lib.readers import roofline

STAGE, PATTERN = "tracer_layered", "tracer_adv_kernel"


def read(run, cell):
    return roofline(run, cell.config, STAGE, PATTERN)
