"""Seconds of the graphs' capture with its warm-up step (``utils/graph.py``
``Block.capture_seconds``, summed over the model's blocks; layer: compiled block)."""


def read(run, cell):
    return run.get("capture_s")
