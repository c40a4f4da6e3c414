"""Staggered C-grid location tags and the zipper sign convention.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/location.py`` (the same table).

The reference classifies every field by its (x, y) staggered location
(``Face``/``Center`` per dimension, Oceananigans location system — SURVEY.md O2) and
derives the zipper-fold sign from that location (``src/tripolar_grid_extensions.jl:49-53``):

    (Face,   Face)   -> +1   (e.g. vorticity)
    (Face,   Center) -> -1   (u-velocity-like: signed x-vector)
    (Center, Face)   -> -1   (v-velocity-like: signed y-vector)
    (Center, Center) -> +1   (tracers, η)

In this design, locations are plain static strings ``"f"``/``"c"`` per
dimension — a tiny rules table rather than a dispatch hierarchy (SURVEY.md §7 design
stance). They are compile-time constants that select which fold index-map the halo fill
uses; nothing about them exists at runtime inside jit.
"""

from __future__ import annotations

FACE = "f"
CENTER = "c"

# Canonical (x, y) location pairs.
CC = (CENTER, CENTER)
FC = (FACE, CENTER)
CF = (CENTER, FACE)
FF = (FACE, FACE)

_VALID = {CC, FC, CF, FF}


def validate_location(loc):
    loc = tuple(loc)
    if loc not in _VALID:
        raise ValueError(f"Invalid staggered location {loc!r}; expected one of {_VALID}")
    return loc


def default_zipper_sign(loc) -> int:
    """Zipper sign from staggered location.

    Port of the location heuristic at ``src/tripolar_grid_extensions.jl:49-53``
    ("fields on edges are signed vectors, fields on nodes and centers are scalars").
    """
    lx, ly = validate_location(loc)
    if (lx, ly) in (FC, CF):
        return -1
    return 1


def sign_for_field_name(name: str) -> int:
    """Zipper sign by prognostic-field name: -1 for u and v, +1 otherwise.

    Port of ``src/tripolar_grid_extensions.jl:32`` (``field_name == :u || :v ? -1 : 1``).
    """
    return -1 if name in ("u", "v") else 1
