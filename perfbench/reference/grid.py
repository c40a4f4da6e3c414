"""The tripolar grid of the reference: coordinates and metrics in float64 numpy.

A frozen, trimmed restatement of the port's numpy route
(``grids/tripolar.py:build_tripolar_arrays`` with ``backend="numpy"``, uniform
latitude rows, ``grids/geometry.py``, ``grids/latlon.py``), which follows
OrthogonalSphericalShellGrids.jl (``src/tripolar_grid.jl``,
``src/generate_tripolar_coordinates.jl``, ``src/tripolar_grid_utils.jl``). It
imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np

from . import fills

R_EARTH = 6371.0e3
COORDS = ("lam_cc", "lam_fc", "lam_cf", "lam_ff", "phi_cc", "phi_fc", "phi_cf", "phi_ff")
METRICS = ("dx_cc", "dx_fc", "dx_cf", "dx_ff", "dy_cc", "dy_fc", "dy_cf", "dy_ff",
           "az_cc", "az_fc", "az_cf", "az_ff")


def _sind(x):
    """Degree-exact sine (Julia's ``sind``: exact at multiples of 90°, signed zeros at
    multiples of 180°, which decide the atan branch on the λ = ±180 meridian)."""
    x = np.asarray(x, dtype=np.float64)
    r = np.mod(x, 360.0)
    out = np.sin(np.radians(r))
    out = np.where(np.mod(r, 180.0) == 0.0, np.copysign(0.0, x), out)
    out = np.where(r == 90.0, 1.0, out)
    return np.where(r == 270.0, -1.0, out)


def _cosd(x):
    return _sind(np.asarray(x, dtype=np.float64) + 90.0)


def _tand(x):
    return _sind(x) / _cosd(x)


def _murray(lam1d, phi1d, focal, first_pole_longitude):
    """The Murray mapping of one staggered location over the (Ny, Nx) index space:
    (λ, φ) in degrees."""
    lam = np.asarray(lam1d, dtype=np.float64)[None, :]
    phi = np.asarray(phi1d, dtype=np.float64)[:, None]
    psi = np.arcsinh(_tand((90.0 - phi) / 2.0) / focal)
    x = focal * _sind(lam) * np.cosh(psi)
    y = focal * _cosd(lam) * np.sinh(psi)
    with np.errstate(divide="ignore", invalid="ignore"):
        lam2 = -(180.0 / math.pi) * np.arctan(y / x)
    on_pole = (x == 0.0) & (y == 0.0)
    lam2 = np.where(on_pole, np.where(lam == -180.0, -90.0, 90.0), lam2)
    phi2 = 90.0 - (360.0 / math.pi) * np.arctan(np.sqrt(x * x + y * y))
    lam2 = lam2 + np.where(lam < 0.0, -90.0, 90.0) + first_pole_longitude + 90.0
    return ((lam2 % 360) + 360) % 360, phi2


def _haversine(lon1, lat1, lon2, lat2, radius):
    d2r = math.pi / 180.0
    a = (np.sin((lat2 - lat1) * d2r / 2) ** 2
         + np.cos(lat1 * d2r) * np.cos(lat2 * d2r) * np.sin((lon2 - lon1) * d2r / 2) ** 2)
    return 2 * radius * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def _cartesian(phi, lam):
    d2r = math.pi / 180.0
    return (np.cos(phi * d2r) * np.cos(lam * d2r), np.cos(phi * d2r) * np.sin(lam * d2r),
            np.sin(phi * d2r))


def _triangle(a, b, c):
    """Solid angle of a spherical triangle of unit vectors (Van Oosterom and
    Strackee)."""
    def dot(p, q):
        return p[0] * q[0] + p[1] * q[1] + p[2] * q[2]

    cross = (b[1] * c[2] - b[2] * c[1], b[2] * c[0] - b[0] * c[2], b[0] * c[1] - b[1] * c[0])
    return 2.0 * np.arctan2(np.abs(dot(a, cross)), 1.0 + dot(a, b) + dot(b, c) + dot(a, c))


def _quad(a, b, c, d):
    return _triangle(a, b, c) + _triangle(a, c, d)


def _embed(interior, Hx, Hy):
    Ny, Nx = interior.shape
    out = np.zeros((Ny + 2 * Hy, Nx + 2 * Hx))
    out[Hy:Hy + Ny, Hx:Hx + Nx] = interior
    return out


def tripolar(Nx, Ny, halo, *, southernmost_latitude=-80.0, north_poles_latitude=55.0,
             first_pole_longitude=70.0, radius=R_EARTH):
    """{name: (Ny + 2·halo, Nx + 2·halo) float64 array} of the 8 coordinates (degrees)
    and 12 metrics (m, m²) of the tripolar grid, halos filled by the zipper (+1) north,
    periodic in x, the south continued by the latitude-longitude metrics."""
    H = int(halo)
    focal = _tand((90.0 - north_poles_latitude) / 2.0)
    dlam = 360.0 / Nx
    lamF = -180.0 + dlam * np.arange(Nx, dtype=np.float64)
    lamC = lamF + dlam / 2.0
    phiC = np.linspace(southernmost_latitude, 90.0, Ny)
    phiF = phiC - (phiC[1] - phiC[0]) / 2.0
    lamF, lamC = np.roll(lamF, Nx // 4), np.roll(lamC, Nx // 4)
    out = {}
    for loc, (l1, p1) in {"ff": (lamF, phiF), "fc": (lamF, phiC), "cf": (lamC, phiF),
                          "cc": (lamC, phiC)}.items():
        lam, phi = _murray(l1, p1, focal, first_pole_longitude)
        for name, a in (("lam_" + loc, lam), ("phi_" + loc, phi)):
            out[name] = fills.fill(_embed(a, H, H), loc, 1, Nx, Ny, H, H, south=False)

    J, Jp, Jm = slice(H, H + Ny), slice(H + 1, H + Ny + 1), slice(H - 1, H + Ny - 1)
    I, Ip, Im = slice(H, H + Nx), slice(H + 1, H + Nx + 1), slice(H - 1, H + Nx - 1)

    def hav(loc, Ja, Ia, Jb, Ib):
        lam, phi = out["lam_" + loc], out["phi_" + loc]
        return _haversine(lam[Ja, Ia], phi[Ja, Ia], lam[Jb, Ib], phi[Jb, Ib], radius)

    def cart(loc, Ja, Ia):
        return _cartesian(out["phi_" + loc][Ja, Ia], out["lam_" + loc][Ja, Ia])

    m = dict(dx_cc=hav("fc", J, Ip, J, I), dx_fc=hav("cc", J, I, J, Im),
             dx_cf=hav("ff", J, Ip, J, I), dx_ff=hav("cf", J, I, J, Im),
             dy_cc=hav("cf", Jp, I, J, I), dy_fc=hav("ff", Jp, I, J, I),
             dy_cf=hav("cc", J, I, Jm, I), dy_ff=hav("fc", J, I, Jm, I))
    m["az_cc"] = _quad(cart("ff", J, I), cart("ff", J, Ip), cart("ff", Jp, Ip),
                       cart("ff", Jp, I)) * radius ** 2
    m["az_fc"] = m["dy_fc"] * m["dx_fc"]
    m["az_cf"] = m["dy_cf"] * m["dx_cf"]
    m["az_ff"] = _quad(cart("cc", Jm, Im), cart("cc", Jm, I), cart("cc", J, I),
                       cart("cc", J, Im)) * radius ** 2

    # south halo and the first interior row: the latitude-longitude metrics
    dphi = (90.0 - southernmost_latitude) / Ny
    j = np.arange(1 - H, 2)
    phi_f = southernmost_latitude + (j - 1) * dphi
    phi_c = southernmost_latitude + (j - 0.5) * dphi
    d2r = math.pi / 180.0
    dx_c = radius * dlam * d2r * np.cos(phi_c * d2r)
    dx_f = radius * dlam * d2r * np.cos(phi_f * d2r)
    az_c = radius ** 2 * dlam * d2r * (np.sin((phi_f + dphi) * d2r) - np.sin(phi_f * d2r))
    az_f = radius ** 2 * dlam * d2r * (np.sin(phi_c * d2r) - np.sin((phi_c - dphi) * d2r))
    south = dict(dx_cc=dx_c, dx_fc=dx_c, dx_cf=dx_f, dx_ff=dx_f, az_cc=az_c, az_fc=az_c,
                 az_cf=az_f, az_ff=az_f)
    for name, a in m.items():
        a = fills.fill(_embed(a, H, H), name.split("_")[1], 1, Nx, Ny, H, H, south=False)
        a[:H + 1, :] = radius * dphi * d2r if name.startswith("dy") else south[name][:, None]
        out[name] = a
    return out
