"""ms a layered step of device time in PyTorch's own kernels (names holding
``at::native``): the AB2 weights, the depth sums, the plain predictor, the implicit
solves, the depth mean and the tracer update, and the copies and fills between them
(layer: step; torch.profiler)."""

from perfbench.lib.readers import device_ms_per_step
from perfbench.lib.trace import kernel_seconds

PATTERN = "at::native"


def read(run, cell):
    if device_ms_per_step(run) is None:  # no device trace
        return None
    seconds = kernel_seconds(run["trace"], PATTERN)
    return None if seconds is None else 1e3 * seconds / run["steps"]
