"""The loop's waits for the card a step: the program's ``wait.*`` counters (the
wizard's CFL, the progress line, the NaN check, each output field's host copy, the
run's end) over the window's steps (layer: driver)."""

from perfbench.lib import spans


def read(run, cell):
    return spans.waits_per_step(run)
