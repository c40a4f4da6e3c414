"""Mean ms of the writer's zip append, its deflate and disk write (the program's span
``osg.output.write``, ``utils/output.py``; layer: driver)."""

from perfbench.lib import spans


def read(run, cell):
    return spans.mean_ms("osg.output.write")
