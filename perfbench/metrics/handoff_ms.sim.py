"""Mean ms a write waited on the simulation thread for the writer thread to finish
the previous snapshot: the program's spans ``osg.output.handoff`` summed over the
writes (its spans ``osg.output.copy``), ``utils/output.py``; layer: driver. 0 where
the program records spans but no write waited; None where it records none."""

from perfbench.lib import spans


def read(run, cell):
    got = spans.registry()[0]
    writes = sum(s[0] == "osg.output.copy" for s in got)
    if not writes:
        return None
    waited = sum(s[2] - s[1] for s in got if s[0] == "osg.output.handoff" and s[2] is not None)
    return 1e-6 * waited / writes
