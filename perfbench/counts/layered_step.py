"""The whole time step of the layered model, whatever launches it is made of: the
least the card could take for it, which bounds every stage that a later change fuses
or removes.

Operations: the barotropic subcycle (``counts/barotropic.py``), the layered momentum,
tracer and vertical stages (``counts/momentum_layered.py``, ``tracer_layered.py``,
``vertical.py``), and a point and layer: the implicit solves 8 for each of u, v and
the tracers (a forward sweep of six, the back substitution of two), the AB2
predictor 6 for each of u, v and the tracers, the depth sums of the forcing and of
the predicted velocities 8, the depth-mean correction 4.

Bytes: the prognostic stacks (u, v, the tracers) and their previous tendencies read
once and written once, and so η, U and V on the widened grid; the static planes
once: on the base grid the metrics (9, and f with Coriolis), the wet-layer counts (4
bytes a point), the wind's two planes; on the widened grid the subcycle's 7. Every
per-layer mask and closure factor can be made from those, so none is counted, here
or in a stage's count: no stage needs more of a kind of plane than the step.
"""

import importlib.util
import pathlib

from perfbench.lib.shapes import of

HERE = pathlib.Path(__file__).resolve().parent
STAGES = ("barotropic", "momentum_layered", "tracer_layered", "vertical")


def _ops(stage, cfg):
    spec = importlib.util.spec_from_file_location(f"perfbench_counts_{stage}",
                                                  HERE / f"{stage}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count(cfg)[0]


def count(cfg):
    """(operations, bytes) of one step."""
    s, nz = of(cfg), cfg["nz"]
    fields = 2 + s.n_tr
    ops = sum(_ops(stage, cfg) for stage in STAGES) + (
        (8 + 6) * fields + 8 + 4) * s.N * nz
    state = 2 * 2 * fields * nz * s.P + 2 * 3 * s.Pe
    static = (9 + int(bool(cfg["physics"].get("coriolis"))) + 2) * s.P + 7 * s.Pe
    return ops, (state + static) * s.word + 4 * s.P
