"""Seconds from the start of the process to the start of the window: imports, the
card, the grid, the model, the capture and the warm block (host clock)."""


def read(run, cell):
    return run["setup_s"]
