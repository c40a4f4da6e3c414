"""SYPD of the serial blocks: simulated years per wall-clock day over the window
(host clock, the window closed by a synchronization of the card)."""

from perfbench.lib.readers import sypd


def read(run, cell):
    return sypd(run)
