"""The whole time step of the single-layer model, whatever launches it is made of: the
least the card could take for it, which bounds every stage that a later change fuses
or removes.

Operations: the barotropic subcycle (``counts/barotropic.py``), the momentum tendency
(130 a point: the vorticity, û, v̂, two WENO-5 reconstructions, the kinetic energy)
and the tracer tendency (110 a point and tracer: two WENO-5 faces, the fluxes).

Bytes: the prognostic state read once and written once (u, v, the tracers and their
previous tendencies on the base grid; η, U and V on the widened grid), and the static
fields read once: on the base grid the metrics and column depths (9 planes, plus f
with Coriolis), on the widened grid the subcycle's 7.
"""

import importlib.util
import pathlib

from perfbench.lib.shapes import of

HERE = pathlib.Path(__file__).resolve().parent


def _barotropic(cfg):
    spec = importlib.util.spec_from_file_location("perfbench_counts_barotropic",
                                                  HERE / "barotropic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.count(cfg)[0]


def count(cfg):
    """(operations, bytes) of one step of one member."""
    s = of(cfg)
    ops = _barotropic(cfg) + (130 + 110 * s.n_tr) * s.N
    state = 2 * (2 + 2 * s.n_tr) * s.P + 2 * 3 * s.Pe
    static = (9 + int(bool(cfg["physics"].get("coriolis")))) * s.P + 7 * s.Pe
    return ops, (state + static) * s.word
