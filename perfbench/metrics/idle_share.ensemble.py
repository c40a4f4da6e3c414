"""% of the traced window of the ensemble's blocks in which the card ran nothing
(layer: device; torch.profiler)."""

from perfbench.lib.readers import idle_share


def read(run, cell):
    return idle_share(run)
