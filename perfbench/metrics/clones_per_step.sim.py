"""Clones of the state out of the graphs' buffers a step (the program's span
``osg.sim.clone``, ``Simulation.state``; layer: driver)."""

from perfbench.lib import spans


def read(run, cell):
    return spans.spans_per_step(run, "osg.sim.clone")
