"""Spherical geometry primitives used at grid-construction time.

Counterpart: ``orthogonalsphericalshellgrids_tpu/grids/geometry.py`` (the same numpy
code; grid generation stays float64 on the host in both packages).

Reimplementation of the geometry utilities the reference pulls from
Distances.jl and Oceananigans.Grids (see reference usage at
``src/tripolar_grid_utils.jl:13-43`` and ``src/OrthogonalSphericalShellGrids.jl:12-14``):

- ``haversine``: great-circle distance between two (lon, lat) points in degrees
  (Distances.jl semantics).
- ``lat_lon_to_cartesian``: unit-sphere cartesian coordinates from (lat, lon) degrees.
- ``spherical_area_triangle`` / ``spherical_area_quadrilateral``: spherical excess of a
  triangle/quadrilateral from its cartesian vertices (Eriksson 1990 / van Oosterom &
  Strackee formula, matching Oceananigans.Grids.spherical_area_quadrilateral).

All functions are array-library agnostic: pass ``xp=numpy`` for float64 host-side grid
generation (mirroring the reference's CPU-side generation,
``src/tripolar_grid.jl:68-71``) or ``xp=torch`` for on-device use. They are pure and
vectorize over arbitrary leading dimensions.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "deg2rad",
    "sind",
    "cosd",
    "tand",
    "haversine",
    "lat_lon_to_cartesian",
    "spherical_area_triangle",
    "spherical_area_quadrilateral",
    "convert_to_0_360",
    "R_EARTH",
]

# Mean Earth radius in meters, identical to Oceananigans.Grids.R_Earth
# (used as the reference's default ``radius`` kwarg, src/tripolar_grid.jl:63).
R_EARTH = 6371.0e3


def deg2rad(x, xp=np):
    return x * (math.pi / 180.0)


def sind(x, xp=np):
    return xp.sin(deg2rad(x))


def cosd(x, xp=np):
    return xp.cos(deg2rad(x))


def tand(x, xp=np):
    return xp.tan(deg2rad(x))


def haversine(lon1, lat1, lon2, lat2, radius, xp=np):
    """Great-circle distance between (lon1, lat1) and (lon2, lat2), degrees in, meters out.

    Matches Distances.jl ``haversine((λ1, φ1), (λ2, φ2), radius)`` as used by the
    reference metric kernel (``src/tripolar_grid_utils.jl:13-21``). Periodic in
    longitude by construction (only sin²(Δλ/2) enters), so halo longitudes that jump
    across the 0/360 seam are handled correctly.
    """
    dlat = deg2rad(lat2 - lat1, xp)
    dlon = deg2rad(lon2 - lon1, xp)
    a = xp.sin(dlat / 2) ** 2 + xp.cos(deg2rad(lat1, xp)) * xp.cos(deg2rad(lat2, xp)) * xp.sin(dlon / 2) ** 2
    # Clamp for numerical safety at antipodal/zero distances.
    a = xp.clip(a, 0.0, 1.0)
    return 2 * radius * xp.arcsin(xp.sqrt(a))


def lat_lon_to_cartesian(lat, lon, radius, xp=np):
    """(x, y, z) on the sphere of ``radius`` from latitude/longitude in degrees.

    Same convention as Oceananigans.Grids.lat_lon_to_cartesian (used at
    ``src/tripolar_grid_utils.jl:23-43``).
    """
    x = radius * cosd(lat, xp) * cosd(lon, xp)
    y = radius * cosd(lat, xp) * sind(lon, xp)
    z = radius * sind(lat, xp)
    return x, y, z


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _triple(a, b, c):
    # a · (b × c)
    bx_c = (
        b[1] * c[2] - b[2] * c[1],
        b[2] * c[0] - b[0] * c[2],
        b[0] * c[1] - b[1] * c[0],
    )
    return _dot(a, bx_c)


def spherical_area_triangle(a, b, c, xp=np):
    """Solid angle of the spherical triangle with unit-vector vertices a, b, c.

    Van Oosterom & Strackee (1983): tan(E/2) = |a·(b×c)| / (1 + a·b + b·c + a·c),
    the same formula as Oceananigans.Grids.spherical_area_triangle. Vertices are
    3-tuples of (arrays of) cartesian components on the unit sphere.
    """
    num = xp.abs(_triple(a, b, c))
    den = 1.0 + _dot(a, b) + _dot(b, c) + _dot(a, c)
    return 2.0 * xp.arctan2(num, den)


def spherical_area_quadrilateral(a, b, c, d, xp=np):
    """Solid angle of the spherical quadrilateral (a, b, c, d), split into two triangles.

    Mirrors Oceananigans.Grids.spherical_area_quadrilateral =
    triangle(a,b,c) + triangle(a,c,d), consumed by the reference's area metric
    computation (``src/tripolar_grid_utils.jl:23-28, :38-43``).
    """
    return spherical_area_triangle(a, b, c, xp) + spherical_area_triangle(a, c, d, xp)


def convert_to_0_360(x):
    """Wrap longitudes into [0, 360). Port of ``convert_to_0_360``
    (``src/OrthogonalSphericalShellGrids.jl:24``)."""
    return ((x % 360) + 360) % 360
