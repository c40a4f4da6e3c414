"""WENO-5 (Z-weights) upwind reconstructions.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/advection.py`` (``_weno5_left``,
``weno5_upwind_faces_from_centers``, ``weno5_upwind_centers_from_faces``) — the
schemes of the Bickley jet: flux-form WENO-5 for the tracer and the upwinded WENO-5
vorticity of ``WENOVectorInvariant`` (``examples/bickley_jet.jl:48-49``). The other
schemes of the JAX package (WENO-7, upwind3, centered, centered4) are not ported yet.

The upwind stencil is selected on the inputs, so only one biased reconstruction is
computed. The arithmetic order matches the JAX package term for term.
"""

from __future__ import annotations

import torch

from .operators import shift_m, shift_p

__all__ = ["weno5_upwind_faces_from_centers", "weno5_upwind_centers_from_faces"]

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
