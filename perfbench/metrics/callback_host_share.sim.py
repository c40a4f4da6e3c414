"""% of the window in the callbacks, timed where they run: the union of the program's
spans of the wizard, the progress line, the NaN check, the writer's copy and write, and
the clone of the state that a callback's first read makes, on the simulation thread
(``utils/simulation.py``, ``utils/output.py``; layer: driver)."""

from perfbench.lib import spans


def read(run, cell):
    return spans.host_share(run)
