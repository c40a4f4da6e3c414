"""The program's own spans and counters (``utils/profiling.py``: ``spans()``,
``counters()``), which it records only while a profiler runs: in a ``--trace 1`` run,
the traced window, since a run is one cell in one process. A program that records
none (an older checkout) gives an empty registry, and the readers of it None.

A span is (name, start_ns, end_ns, parent, key, thread); ``end_ns`` is None while it
is open.
"""

from __future__ import annotations

# the callbacks' spans of the simulation loop and its writer, as the program names
# them, and the state's clone out of the graphs' buffers that a callback's first read
# of the state makes
CALLBACKS = ("osg.sim.wizard", "osg.sim.progress", "osg.sim.nan_check", "osg.output.copy",
             "osg.output.write", "osg.sim.clone")


def registry():
    """(spans, counters) of the program; ([], {}) where it records none."""
    try:
        from orthogonalsphericalshellgrids_tpu_torch.utils import profiling

        return list(profiling.spans()), dict(profiling.counters())
    except (ImportError, AttributeError):
        return [], {}


def _closed(spans, names):
    return [s for s in spans if s[0] in names and s[2] is not None]


def mean_ms(name):
    """Mean ms of the closed spans ``name``; None where there is none."""
    got = _closed(registry()[0], (name,))
    return 1e-6 * sum(s[2] - s[1] for s in got) / len(got) if got else None


def host_share(run):
    """% of the window covered by the union of the ``CALLBACKS`` spans on the
    simulation thread (the thread of the ``osg.sim.*`` spans); None where it has
    none."""
    spans = registry()[0]
    threads = {s[5] for s in spans if s[0].startswith("osg.sim.")}
    merged = []
    for a, b in sorted((s[1], s[2]) for s in _closed(spans, CALLBACKS) if s[5] in threads):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if not merged or not run["window_s"]:
        return None
    return 100.0 * sum(b - a for a, b in merged) * 1e-9 / run["window_s"]


def waits_per_step(run):
    """The ``wait.*`` counts over the window's steps; None where the program counts
    none."""
    counts = registry()[1]
    n = sum(v for k, v in counts.items() if k.startswith("wait."))
    return n / run["steps"] if counts and run["steps"] else None


def spans_per_step(run, name):
    """The spans ``name`` over the window's steps (0 where the program records spans
    but none of these); None where the program records no span."""
    spans = registry()[0]
    if not spans or not run["steps"]:
        return None
    return sum(s[0] == name for s in spans) / run["steps"]
