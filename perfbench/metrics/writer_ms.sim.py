"""Mean ms of a write on the simulation thread (the host copy, the zip append; layer:
driver, ``utils/output.py``)."""

import statistics


def read(run, cell):
    times = run.get("callbacks", {}).get("writer")
    return 1e3 * statistics.fmean(times) if times else None
