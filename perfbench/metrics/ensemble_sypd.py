"""Member-SYPD of an ensemble: the simulated seconds of every member's steps in the
window over the window's seconds, / 365 (host clock, the window closed by a
synchronization of the card)."""

from perfbench.lib.readers import sypd


def read(run, cell):
    return sypd(run)
