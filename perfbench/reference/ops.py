"""Finite-volume operators of the reference on halo-inclusive torch tensors (layout
(..., y, x)): shifts, differences and averages between centers and faces, and the upwind
WENO-5 reconstructions.

A frozen restatement of the port's ``ops/operators.py`` and ``ops/advection.py``
(WENO-5 only). A shift wraps at the array
edge, so only halo cells become invalid.
"""

from __future__ import annotations

import torch

X, Y = -1, -2
_EPS = 1e-8  # the WENO smoothness regularizer


def sp(a, axis):
    """out[k] = a[k + 1]."""
    return torch.roll(a, -1, dims=axis)


def sm(a, axis):
    """out[k] = a[k - 1]."""
    return torch.roll(a, 1, dims=axis)


def dxc(f):
    return sp(f, X) - f


def dxf(c):
    return c - sm(c, X)


def dyc(f):
    return sp(f, Y) - f


def dyf(c):
    return c - sm(c, Y)


def ixc(f):
    return 0.5 * (f + sp(f, X))


def ixf(c):
    return 0.5 * (c + sm(c, X))


def iyc(f):
    return 0.5 * (f + sp(f, Y))


def iyf(c):
    return 0.5 * (c + sm(c, Y))


def inv(m):
    """1/m where m > 0, else 0."""
    return torch.where(m > 0, 1.0 / torch.where(m > 0, m, torch.ones_like(m)),
                       torch.zeros_like(m))


def _weno5_left(m3, m2, m1, p0, p1):
    """WENO-5 reconstruction at the interface from the left of (m3, m2, m1 | p0, p1)."""
    q0 = (2.0 * m3 - 7.0 * m2 + 11.0 * m1) / 6.0
    q1 = (-m2 + 5.0 * m1 + 2.0 * p0) / 6.0
    q2 = (2.0 * m1 + 5.0 * p0 - p1) / 6.0
    b0 = (13.0 / 12.0) * (m3 - 2.0 * m2 + m1) ** 2 + 0.25 * (m3 - 4.0 * m2 + 3.0 * m1) ** 2
    b1 = (13.0 / 12.0) * (m2 - 2.0 * m1 + p0) ** 2 + 0.25 * (m2 - p0) ** 2
    b2 = (13.0 / 12.0) * (m1 - 2.0 * p0 + p1) ** 2 + 0.25 * (3.0 * m1 - 4.0 * p0 + p1) ** 2
    tau = torch.abs(b0 - b2)
    a0 = 0.1 * (1.0 + (tau / (b0 + _EPS)) ** 2)
    a1 = 0.6 * (1.0 + (tau / (b1 + _EPS)) ** 2)
    a2 = 0.3 * (1.0 + (tau / (b2 + _EPS)) ** 2)
    return (a0 * q0 + a1 * q1 + a2 * q2) / (a0 + a1 + a2)


def weno5_faces(c, vel, axis):
    """Upwind WENO-5 value of the center field ``c`` at the faces, by the sign of the
    face velocity ``vel``; face k lies between centers k - 1 and k."""
    cm1 = sm(c, axis)
    cm2 = sm(cm1, axis)
    cm3 = sm(cm2, axis)
    cp1 = sp(c, axis)
    cp2 = sp(cp1, axis)
    pos = vel > 0.0

    def sel(a, b):
        return torch.where(pos, a, b)

    return _weno5_left(sel(cm3, cp2), sel(cm2, cp1), sel(cm1, c), sel(c, cm1),
                       sel(cp1, cm2))


def weno5_centers(f, vel, axis):
    """Upwind WENO-5 value of the face field ``f`` at the centers, by the sign of the
    center velocity ``vel``."""
    return sp(weno5_faces(f, sm(vel, axis), axis), axis)

