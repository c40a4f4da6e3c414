"""Mean ms of the writer's output functions, host copies and crops (the program's span
``osg.output.copy``, ``utils/output.py``; layer: driver)."""

from perfbench.lib import spans


def read(run, cell):
    return spans.mean_ms("osg.output.copy")
