"""Advection schemes: WENO-5 (Z-weights), WENO-7, third-order upwind, centered.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/advection.py``, function for
function: the schemes of the Bickley jet (flux-form WENO-5 for the tracer and the
upwinded WENO-5 vorticity of ``WENOVectorInvariant``, ``examples/bickley_jet.jl:48-49``)
and the rest of the models' ``tracer_advection=`` menu (``TRACER_SCHEMES``: the
Oceananigans ``WENO(order=5)``, ``WENO(order=7)``, ``UpwindBiased(order=3)``,
``Centered(order=2)`` and ``Centered(order=4)``).

Every reconstruction is a shape-preserving operation on halo-inclusive ``(..., y, x)``
tensors, ``SCHEME_RADIUS`` halo cells of reach on each side. The upwind stencils are
selected on the inputs, so only one biased reconstruction is computed. The arithmetic
order matches the JAX package term for term, so the faces are bitwise equal at
float64. On a card WENO-5 tracer advection runs in ``kernels/tracer_adv.py``; the
other schemes are these functions, plain PyTorch, as they are plain XLA in the JAX
package.
"""

from __future__ import annotations

import torch

from .operators import shift_m, shift_p

__all__ = ["weno5_faces_from_centers", "weno5_centers_from_faces",
           "weno5_upwind_faces_from_centers", "weno5_upwind_centers_from_faces",
           "weno7_upwind_faces_from_centers", "upwind3_faces_from_centers",
           "upwind_select", "centered_faces_from_centers", "centered4_faces_from_centers",
           "tracer_faces", "TRACER_SCHEMES", "SCHEME_RADIUS"]

# tracer_advection= option names accepted by the models
TRACER_SCHEMES = ("weno5", "weno7", "upwind3", "centered", "centered4")

# halo cells each reconstruction consumes on each side (checked against the grid halo
# at model build)
SCHEME_RADIUS = {"weno5": 3, "weno7": 4, "upwind3": 2, "centered": 1, "centered4": 2}


def tracer_faces(c, vel, axis, scheme):
    """Face reconstruction of a center field under the named tracer-advection scheme;
    ``vel`` drives the upwinding (the centered schemes ignore it)."""
    if scheme == "weno5":
        return weno5_upwind_faces_from_centers(c, vel, axis)
    if scheme == "weno7":
        return weno7_upwind_faces_from_centers(c, vel, axis)
    if scheme == "upwind3":
        return upwind3_faces_from_centers(c, vel, axis)
    if scheme == "centered":
        return centered_faces_from_centers(c, axis)
    if scheme == "centered4":
        return centered4_faces_from_centers(c, axis)
    raise ValueError(f"unknown tracer_advection {scheme!r}; options: {TRACER_SCHEMES}")


_EPS = 1e-8  # smoothness regularizer; float32-safe


def _weno5_left(m3, m2, m1, p0, p1):
    """WENO-5 reconstruction at the interface from the LEFT (upwind for positive
    flow) from the five cells (m3, m2, m1 | p0, p1) around it."""
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
    s = a0 + a1 + a2
    return (a0 * q0 + a1 * q1 + a2 * q2) / s


def weno5_faces_from_centers(c, axis):
    """Both biased WENO-5 reconstructions of a center field at the faces, ``(left,
    right)``: from below (the upwind value for positive velocity) and from above. Face
    k sits between centers k-1 and k."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cm3 = shift_m(cm2, axis)
    cp0 = c
    cp1 = shift_p(c, axis)
    left = _weno5_left(cm3, cm2, cm1, cp0, cp1)
    # the mirror image: (c[k+2], c[k+1], c[k] | c[k-1], c[k-2])
    cp2 = shift_p(cp1, axis)
    right = _weno5_left(cp2, cp1, cp0, cm1, cm2)
    return left, right


def weno5_centers_from_faces(f, axis):
    """Both biased WENO-5 reconstructions of a face field at the centers: center k
    sits at face index k+1, so the faces' reconstructions shift down by one."""
    left, right = weno5_faces_from_centers(f, axis)
    return shift_p(left, axis), shift_p(right, axis)


def weno5_upwind_faces_from_centers(c, vel, axis):
    """Upwind WENO-5 face reconstruction of a center field; ``vel`` is the
    face-located advecting velocity. Face k sits between centers k-1 and k."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cm3 = shift_m(cm2, axis)
    cp1 = shift_p(c, axis)
    cp2 = shift_p(cp1, axis)
    pos = vel > 0.0

    def sel(a, b):
        return torch.where(pos, a, b)

    # positive flow: (c[k-3], c[k-2], c[k-1] | c[k], c[k+1]); negative: mirror image
    return _weno5_left(sel(cm3, cp2), sel(cm2, cp1), sel(cm1, c), sel(c, cm1),
                       sel(cp1, cm2))


def weno5_upwind_centers_from_faces(f, vel, axis):
    """Upwind WENO-5 reconstruction of a face field at centers: center k sits at
    face index k+1, so the upwinding at face j uses the center velocity at j-1 and
    the result shifts down by one."""
    return shift_p(weno5_upwind_faces_from_centers(f, shift_m(vel, axis), axis), axis)


def _weno7_left(m4, m3, m2, m1, p0, p1, p2):
    """WENO-7 reconstruction at the interface from the LEFT (Balsara & Shu 2000
    candidate polynomials and smoothness indicators, Castro–Costa–Don 2011 Z-weights
    with τ₇ = |β₀ + 3β₁ − 3β₂ − β₃|) from the seven cells (m4..m1 | p0..p2) around
    it."""
    q0 = (-3.0 * m4 + 13.0 * m3 - 23.0 * m2 + 25.0 * m1) / 12.0
    q1 = (m3 - 5.0 * m2 + 13.0 * m1 + 3.0 * p0) / 12.0
    q2 = (-m2 + 7.0 * m1 + 7.0 * p0 - p1) / 12.0
    q3 = (3.0 * m1 + 13.0 * p0 - 5.0 * p1 + p2) / 12.0

    b0 = (m4 * (547.0 * m4 - 3882.0 * m3 + 4642.0 * m2 - 1854.0 * m1)
          + m3 * (7043.0 * m3 - 17246.0 * m2 + 7042.0 * m1)
          + m2 * (11003.0 * m2 - 9402.0 * m1) + 2107.0 * m1 * m1)
    b1 = (m3 * (267.0 * m3 - 1642.0 * m2 + 1602.0 * m1 - 494.0 * p0)
          + m2 * (2843.0 * m2 - 5966.0 * m1 + 1922.0 * p0)
          + m1 * (3443.0 * m1 - 2522.0 * p0) + 547.0 * p0 * p0)
    b2 = (m2 * (547.0 * m2 - 2522.0 * m1 + 1922.0 * p0 - 494.0 * p1)
          + m1 * (3443.0 * m1 - 5966.0 * p0 + 1602.0 * p1)
          + p0 * (2843.0 * p0 - 1642.0 * p1) + 267.0 * p1 * p1)
    b3 = (m1 * (2107.0 * m1 - 9402.0 * p0 + 7042.0 * p1 - 1854.0 * p2)
          + p0 * (11003.0 * p0 - 17246.0 * p1 + 4642.0 * p2)
          + p1 * (7043.0 * p1 - 3882.0 * p2) + 547.0 * p2 * p2)

    tau = torch.abs(b0 + 3.0 * b1 - 3.0 * b2 - b3)
    a0 = (1.0 / 35.0) * (1.0 + (tau / (b0 + _EPS)) ** 2)
    a1 = (12.0 / 35.0) * (1.0 + (tau / (b1 + _EPS)) ** 2)
    a2 = (18.0 / 35.0) * (1.0 + (tau / (b2 + _EPS)) ** 2)
    a3 = (4.0 / 35.0) * (1.0 + (tau / (b3 + _EPS)) ** 2)
    s = a0 + a1 + a2 + a3
    return (a0 * q0 + a1 * q1 + a2 * q2 + a3 * q3) / s


def weno7_upwind_faces_from_centers(c, vel, axis):
    """Upwind WENO-7 face reconstruction, selected on the inputs like WENO-5's (the
    mirror stencil goes through the same reconstruction for negative flow); 4 halo
    cells of reach each side."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cm3 = shift_m(cm2, axis)
    cm4 = shift_m(cm3, axis)
    cp1 = shift_p(c, axis)
    cp2 = shift_p(cp1, axis)
    cp3 = shift_p(cp2, axis)
    pos = vel > 0.0

    def sel(a, b):
        return torch.where(pos, a, b)

    # positive flow: (c[k-4..k-1] | c[k..k+2]); negative: mirror image around the face
    return _weno7_left(sel(cm4, cp3), sel(cm3, cp2), sel(cm2, cp1), sel(cm1, c),
                       sel(c, cm1), sel(cp1, cm2), sel(cp2, cm3))


def upwind3_faces_from_centers(c, vel, axis):
    """Third-order upwind-biased face reconstruction (``UpwindBiased(order=3)``):
    (−c[k−2] + 5c[k−1] + 2c[k])/6 for positive flow, the mirror for negative;
    selected on the inputs, 2 halo cells of reach each side."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cp1 = shift_p(c, axis)
    pos = vel > 0.0

    def sel(a, b):
        return torch.where(pos, a, b)

    return (-sel(cm2, cp1) + 5.0 * sel(cm1, c) + 2.0 * sel(c, cm1)) / 6.0


def upwind_select(vel, left, right):
    """The left-biased value where vel > 0, else the right-biased one."""
    return torch.where(vel > 0.0, left, right)


def centered_faces_from_centers(c, axis):
    """Second-order centered interpolation of centers to faces (``Centered()``)."""
    return 0.5 * (c + shift_m(c, axis))


def centered4_faces_from_centers(c, axis):
    """Fourth-order centered face interpolation (``Centered(order=4)``):
    (7(c[k−1] + c[k]) − (c[k−2] + c[k+1]))/12; 2 halo cells of reach each side."""
    cm1 = shift_m(c, axis)
    cm2 = shift_m(cm1, axis)
    cp1 = shift_p(c, axis)
    return (7.0 * (cm1 + c) - (cm2 + cp1)) / 12.0
