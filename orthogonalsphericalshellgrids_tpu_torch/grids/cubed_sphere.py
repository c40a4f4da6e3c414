"""Minimal conformal cubed-sphere panel: the orthogonality-comparison oracle.

Counterpart: ``orthogonalsphericalshellgrids_tpu/grids/cubed_sphere.py`` (the port
keeps its own copy; numpy, float64, on the host). The reference's orthogonality
test builds a ``ConformalCubedSphereGrid`` panel and asserts that the tripolar grid's
non-orthogonality angle lies strictly inside the panel's
(``test/test_tripolar_grid.jl:36-76``). Only the panel's Face-Face node coordinates
are needed, so this module implements the conformal map square -> sphere of Rancic,
Purser & Mesinger (1996, QJRMS 122, Appendix B): the Taylor series
``W(Z) = sum_k A_k Z^k`` with the published 30-coefficient table.

Construction:

- Corner coordinates ``z = (1-|x|) + i(1-|y|)`` measure the point from the face
  corner; the face has D4 symmetry, so fold into ``arg z in [0, pi/4]``.
- ``Z = (z/2)^4`` opens the corner and makes the map single-valued;
  ``w = W(Z)^{1/3}`` restores the sphere-corner angle 2*pi/3 (a cube corner joins
  three panels). The series is normalised so that ``w = sqrt(2) * s`` where ``s``
  is the stereographic (tan-half-angle) coordinate in a frame centred on the
  sphere corner ``C = (1,1,1)/sqrt(3)``.
- Inverse-stereograph ``s`` in the orthonormal corner frame
  ``f1 = (-2,1,1)/sqrt(6)``, ``f2 = C x f1 = (0,-1,1)/sqrt(2)``, then restore the
  quadrant by the face's reflection symmetries.
"""

from __future__ import annotations

import numpy as np

__all__ = ["A_RANCIC", "conformal_cubed_sphere_coordinates", "conformal_panel_nodes",
           "nonorthogonality_angle"]

# Rancic, Purser & Mesinger (1996) Table B1 — Taylor coefficients of the conformal
# map from the cube face to the spherical panel (public, also used by MITgcm and
# CubedSphere.jl, which backs the reference's ConformalCubedSphereGrid oracle).
A_RANCIC = np.array([
    +1.47713062600964, -0.38183510510174, -0.05573058001191, -0.00895883606818,
    -0.00791315785221, -0.00486625437708, -0.00329251751279, -0.00235481488325,
    -0.00175870527475, -0.00135681133278, -0.00107459847699, -0.00086944475948,
    -0.00071607115121, -0.00059867100093, -0.00050699063239, -0.00043415191279,
    -0.00037541003286, -0.00032741060100, -0.00028773091482, -0.00025458777519,
    -0.00022664642371, -0.00020289261022, -0.00018254510830, -0.00016499474461,
    -0.00014976117168, -0.00013646173946, -0.00012478875823, -0.00011449267279,
    -0.00010536946150, -0.00009725109376,
])


def conformal_cubed_sphere_coordinates(x, y):
    """Map face coordinates ``x, y in [-1, 1]`` (arrays) to cartesian points on the
    unit sphere's +Z ("north") panel of the conformal cubed sphere.

    Returns (X, Y, Z) arrays.  Face corners map to the cube corners
    ``(+-1, +-1, 1)/sqrt(3)``, the face centre to the pole, and the map is
    conformal away from the corners.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xc = 1.0 - np.abs(x)
    yc = 1.0 - np.abs(y)

    # Fold across the face diagonal so arg(z) <= pi/4 (principal cube root below
    # then stays on the correct branch: arg(W) in [0, pi]).
    swap = yc > xc
    a = np.where(swap, yc, xc)
    b = np.where(swap, xc, yc)

    Z = ((a + 1j * b) / 2.0) ** 4
    W = np.zeros_like(Z)
    for Ak in A_RANCIC[::-1]:  # Horner: W = Z*(A1 + Z*(A2 + ...))
        W = Z * (Ak + W)

    r = np.abs(W)
    theta = np.angle(W)
    # arg(W) lives in [0, pi] for the folded sector; rounding at the diagonal
    # (Z on the negative real axis) can wrap it to ~-pi — unwrap that case only.
    theta = np.where(theta < -np.pi / 2, theta + 2.0 * np.pi, theta)
    w = np.where(r == 0.0, 0.0 + 0.0j, np.exp((np.log(np.where(r == 0.0, 1.0, r)) + 1j * theta) / 3.0))
    # Unfold: reflection across the face diagonal is reflection across the
    # corner-to-centre geodesic, i.e. the line arg = pi/3 in the w-plane.
    w = np.where(swap, np.exp(2j * np.pi / 3.0) * np.conj(w), w)

    # w = sqrt(2) * stereographic coordinate in the corner frame.
    s = w / np.sqrt(2.0)
    d = 1.0 + s.real**2 + s.imag**2
    p1 = 2.0 * s.real / d
    p2 = 2.0 * s.imag / d
    p3 = (2.0 - d) / d

    f1 = np.array([-2.0, 1.0, 1.0]) / np.sqrt(6.0)
    f2 = np.array([0.0, -1.0, 1.0]) / np.sqrt(2.0)
    c = np.array([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    X = p1 * f1[0] + p2 * f2[0] + p3 * c[0]
    Y = p1 * f1[1] + p2 * f2[1] + p3 * c[1]
    Zg = p1 * f1[2] + p2 * f2[2] + p3 * c[2]

    # Quadrant restore; on the axes the exact image has X (resp. Y) == 0 — pin it
    # there so series truncation does not leak across the symmetry plane.
    X = np.where(x == 0.0, 0.0, np.where(x < 0.0, -X, X))
    Y = np.where(y == 0.0, 0.0, np.where(y < 0.0, -Y, Y))
    return X, Y, Zg


def conformal_panel_nodes(n):
    """(n+1, n+1) Face-Face node coordinates of one conformal cubed-sphere panel
    with equispaced computational coordinates, as built by the reference's oracle
    ``ConformalCubedSphereGrid(panel_size=(n, n, 1))`` (test/test_tripolar_grid.jl:40).
    """
    xi = np.linspace(-1.0, 1.0, n + 1)
    x, y = np.meshgrid(xi, xi, indexing="ij")
    return conformal_cubed_sphere_coordinates(x, y)


def nonorthogonality_angle(X, Y, Z):
    """Per-node non-orthogonality angle in degrees (reference kernel
    compute_nonorthogonality_angle!, test/test_tripolar_grid.jl:8-34): the angle
    between the +i and +j node-to-node edge vectors, minus 90 deg.  Input arrays are
    node coordinates; output has shape (n0-1, n1-1)."""
    def edges(arr):
        return arr[1:, :-1] - arr[:-1, :-1], arr[:-1, 1:] - arr[:-1, :-1]

    (v1x, v2x), (v1y, v2y), (v1z, v2z) = edges(X), edges(Y), edges(Z)
    dot = v1x * v2x + v1y * v2y + v1z * v2z
    n1 = np.sqrt(v1x**2 + v1y**2 + v1z**2)
    n2 = np.sqrt(v2x**2 + v2y**2 + v2z**2)
    cos = np.clip(dot / (n1 * n2), -1.0, 1.0)
    return np.degrees(np.arccos(cos)) - 90.0
