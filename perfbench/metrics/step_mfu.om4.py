"""% of the whole layered step's least time (``counts/layered_step.py`` at the data
sheet's peaks) over the traced window's time a step (layer: step)."""

from perfbench.lib.readers import device_ms_per_step, least_seconds

STAGE = "layered_step"


def read(run, cell):
    if device_ms_per_step(run) is None:  # no device trace
        return None
    return 100.0 * least_seconds(STAGE, cell.config) / (run["window_s"] / run["steps"])
