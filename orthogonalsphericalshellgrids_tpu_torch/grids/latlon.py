"""Closed-form latitude-longitude grid metrics.

Counterpart: ``orthogonalsphericalshellgrids_tpu/grids/latlon.py`` (the same float64
numpy code).

The reference continues the tripolar grid's metrics into the southern halo rows with the
metrics of a uniform ``LatitudeLongitudeGrid`` spanning the same extent
(``src/tripolar_grid.jl:277-300``; build target SURVEY.md O16). For a uniform spherical
grid those metrics are closed-form functions of latitude, so no helper grid object is
needed — just the formulas:

    Δx(φ) = R · cos(φ) · Δλ_rad        (arc length along a parallel)
    Δy    = R · Δφ_rad                 (constant; arc length along a meridian)
    Az    = R² · Δλ_rad · (sin φ_top − sin φ_bottom)

The helper lat-lon grid in the reference has ``Nφ`` cells over
(southernmost_latitude, 90), i.e. uniform Δφ_ll = (90 − southernmost)/Nφ — note this
differs from the tripolar Δφ = (90 − southernmost)/(Nφ − 1) because the tripolar north
pole is a *center* point (``src/tripolar_grid.jl:95-97``).
"""

from __future__ import annotations

import math

import numpy as np

from .geometry import cosd, sind

__all__ = ["latlon_metrics_1d"]


def latlon_metrics_1d(j, *, southernmost_latitude, Ny, radius, dlam_deg):
    """1-D (in j) lat-lon metrics evaluated at (possibly negative) 1-based row indices.

    ``j`` is an integer array of 1-based row indices (halo rows have j <= 0). Returns a
    dict with Δx at center/face latitudes, scalar Δy, and Az at center/face rows,
    matching the metric continuation targets at ``src/tripolar_grid.jl:281-300``:
    Δx{ff,fc,cf,cc}, Δy (one scalar serves all four locations since
    Δyᶠᶜ = Δyᶜᶠ = R·Δφ for a uniform grid — the reference itself reuses Δyᶠᶜ for Δyᶠᶠ
    and Δyᶜᶠ for Δyᶜᶜ at :292,:295), Az{ff,fc,cf,cc}.
    """
    j = np.asarray(j)
    dphi = (90.0 - southernmost_latitude) / Ny  # lat-lon helper grid spacing
    dlam_rad = math.radians(dlam_deg)
    dphi_rad = math.radians(dphi)

    def phi_face(jj):  # φ at face row jj (1-based): southern edge of cell jj
        return southernmost_latitude + (jj - 1) * dphi

    def phi_center(jj):
        return southernmost_latitude + (jj - 0.5) * dphi

    phiF = phi_face(j)
    phiFp = phi_face(j + 1)
    phiC = phi_center(j)
    phiCm = phi_center(j - 1)

    dx_c = radius * dlam_rad * cosd(phiC)  # Δx at center latitudes (CC and FC rows)
    dx_f = radius * dlam_rad * cosd(phiF)  # Δx at face latitudes (CF and FF rows)
    dy = radius * dphi_rad

    az_c = radius**2 * dlam_rad * (sind(phiFp) - sind(phiF))  # center rows (CC, FC)
    az_f = radius**2 * dlam_rad * (sind(phiC) - sind(phiCm))  # face rows (CF, FF)

    return {
        "dx_cc": dx_c, "dx_fc": dx_c, "dx_cf": dx_f, "dx_ff": dx_f,
        "dy": dy,
        "az_cc": az_c, "az_fc": az_c, "az_cf": az_f, "az_ff": az_f,
    }
