"""SYPD through ``Simulation.run``, its callbacks and writes included (host clock)."""

from perfbench.lib.readers import sypd


def read(run, cell):
    return sypd(run)
