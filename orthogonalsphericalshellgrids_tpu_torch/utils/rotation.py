"""Vector rotation between the tripolar (native) frame and the geographic frame.

Counterpart: ``orthogonalsphericalshellgrids_tpu/utils/rotation.py``, the reference's
recipe ``examples/convert_to_latlong_frame.jl:12-55``: assuming local orthogonality,
the rotation follows from how latitude changes along the native grid directions,

    ũ =  deg2rad(φᶜᶠ[j+1] − φᶜᶠ[j]) / Δyᶜᶜ,   ṽ = −deg2rad(φᶠᶜ[i+1] − φᶠᶜ[i]) / Δxᶜᶜ,
    (d₁, d₂) = (ũ, ṽ) / |(ũ, ṽ)|,

all at cell centers. ``to_native_frame`` is the true inverse of ``to_latlon_frame``
(the JAX package's deliberate deviation from the reference, which flips v).
"""

from __future__ import annotations

import torch

from ..grids.tripolar import TripolarGrid
from ..ops.operators import shift_p

__all__ = ["rotation_angle", "to_latlon_frame", "to_native_frame"]


def _safe_inv(m):
    return torch.where(m != 0, 1.0 / torch.where(m != 0, m, torch.ones_like(m)),
                       torch.zeros_like(m))


def rotation_angle(grid: TripolarGrid):
    """(d1, d2) rotation components at cell centers (cos and sin of the local grid
    tilt); 0 where the tilt is undefined."""
    dphi_y = torch.deg2rad(shift_p(grid.phi_cf, -2) - grid.phi_cf)
    u_t = dphi_y * _safe_inv(grid.dy_cc)
    dphi_x = torch.deg2rad(shift_p(grid.phi_fc, -1) - grid.phi_fc)
    v_t = -dphi_x * _safe_inv(grid.dx_cc)
    mag = torch.sqrt(u_t**2 + v_t**2)
    inv = _safe_inv(mag)
    return u_t * inv, v_t * inv


def to_latlon_frame(grid: TripolarGrid, u_native, v_native):
    """Rotate center-located native-frame vector components into the geographic
    frame (the reference's ``convert_to_latlong_frame``)."""
    d1, d2 = rotation_angle(grid)
    return u_native * d1 - v_native * d2, u_native * d2 + v_native * d1


def to_native_frame(grid: TripolarGrid, u_geo, v_geo):
    """Rotate center-located geographic vector components into the native frame;
    ``to_native_frame ∘ to_latlon_frame`` is the identity."""
    d1, d2 = rotation_angle(grid)
    return u_geo * d1 + v_geo * d2, -u_geo * d2 + v_geo * d1
