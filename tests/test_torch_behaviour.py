"""Behaviour pins of the PyTorch port's models, plain PyTorch on the CPU at float64.

``tests/test_gravity_wave.py`` and ``tests/test_fold_advection.py`` ported, with the
JAX tests' own limits:

- a free-surface bump on a deep all-ocean grid radiates a ring whose front travels
  at √(gH) (within 12 %); a 50 m interface bump between two 500 m layers radiates
  an internal ring at the z-level discrete speed √(Δb·h/4) (within 15 %, and nearer
  to it than to the isopycnal formula);
- a tracer blob advected through the zipper fold by a frozen fold-consistent flow
  keeps its content (1e-8 before it reaches the seam row, 1e-6 after the crossing)
  and re-emerges at the mirrored column.

Each check is a function of the device; ``tests/test_torch_cuda.py`` runs the same
three through the kernels on a card.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch import CC, CF, FC, TripolarGrid  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.ops import zipper  # noqa: E402

torch.set_num_threads(1)

G = 9.80665
H = 4000.0


def _hav(lam1, phi1, lam2, phi2, radius):
    p1, p2 = np.deg2rad(phi1), np.deg2rad(phi2)
    dl = np.deg2rad(np.abs(lam1 - lam2))
    dl = np.minimum(dl, 2 * np.pi - dl)
    a = np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
    return 2 * radius * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def _np(a):
    return a.cpu().numpy()


def test_gravity_wave_speed():
    """The surface ring's elevation maximum travels at √(gH) along the meridian
    through the bump, deep in the lat-lon region (``tests/test_gravity_wave.py``)."""
    gravity_wave_speed("cpu")


def gravity_wave_speed(device):
    grid = TripolarGrid.make((180, 90, 1), dtype=torch.float64, z=(-H, 0.0), device=device)

    def bottom(lam, phi):
        land = (((np.abs(lam - 70.0) < 12) | (np.abs(lam - 250.0) < 12)) & (phi > 45))
        return np.where(land, 1.0, -H - 1.0)

    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=30),
                          bottom_height=bottom, device=device)
    lam0, phi0 = 90.0, -40.0

    def eta0(lam, phi):
        return 0.1 * np.exp(-((_hav(lam, phi, lam0, phi0, grid.radius) / 2.5e5) ** 2))

    state = TH.initial_state(model, eta=eta0)
    dt, n_steps = 600.0, 12
    state = TH.multi_step(model, state, dt, n_steps)
    T = dt * n_steps
    c_expected = np.sqrt(G * H)

    eta = _np(model.grid_ext.interior(state.eta))
    lam_cc = _np(grid.interior(grid.lam_cc))
    phi_cc = _np(grid.interior(grid.phi_cc))
    i0 = int(np.argmin(np.abs(lam_cc[0] - lam0)))
    r_line = _hav(lam_cc[:, i0], phi_cc[:, i0], lam0, phi0, grid.radius)
    north = phi_cc[:, i0] > phi0
    r, e = r_line[north], eta[:, i0][north]
    order = np.argsort(r)
    r_peak = r[order][np.argmax(e[order])]
    c_measured = r_peak / T
    assert np.isfinite(eta).all()
    assert abs(c_measured - c_expected) < 0.12 * c_expected, (
        f"measured {c_measured:.1f} m/s, expected ~{c_expected:.1f} m/s")


def test_internal_gravity_wave_speed_two_layer():
    """The two-layer internal ring travels at the z-level discrete eigenvalue
    c² = Δb·h/4, measured from the ring-peak radius at two times, and the
    measurement tells it from the isopycnal √(Δb·h1·h2/H)
    (``tests/test_gravity_wave.py:test_internal_gravity_wave_speed_two_layer``)."""
    internal_gravity_wave_speed_two_layer("cpu")


def internal_gravity_wave_speed_two_layer(device):
    H2, hl, B0 = 1000.0, 500.0, 0.05
    R = 6371000.0 / 64.0
    grid = TripolarGrid.make((180, 90, 2), dtype=torch.float64, z=(-H2, 0.0), radius=R,
                             device=device)

    def bottom(lam, phi):
        return np.where((phi > 30.0) | (phi < -60.0), 1.0, -H2 - 1.0)

    model = TL.make_layered_model(grid, free_surface=SplitExplicitFreeSurface(substeps=30),
                                  bottom_height=bottom, buoyancy=True, device=device)
    lam0, phi0 = 90.0, -40.0

    def bi(lam, phi, z):
        xi = 50.0 * np.exp(-((_hav(lam, phi, lam0, phi0, R) / 8e3) ** 2))
        return np.where(z > -hl, B0 * (1.0 - xi / hl), 0.0)

    state = TL.layered_initial_state(model, b=bi)
    dt = 120.0
    lam_cc = _np(grid.interior(grid.lam_cc))
    phi_cc = _np(grid.interior(grid.phi_cc))
    i0 = int(np.argmin(np.abs(lam_cc[0] - lam0)))
    wet = _np(model.mask_c3[0])[grid.interior2d][:, i0] > 0
    r_line = _hav(lam_cc[:, i0], phi_cc[:, i0], lam0, phi0, R)
    sel = (phi_cc[:, i0] > phi0) & wet & (r_line > 10e3) & (r_line < 100e3)

    def ring_peak(s):
        b0_layer = _np(s.b)[0][grid.interior2d][:, i0]
        return r_line[sel][np.argmax((B0 - b0_layer)[sel])]

    state = TL.layered_multi_step(model, state, dt, 60)
    r1, T1 = ring_peak(state), 60 * dt
    state = TL.layered_multi_step(model, state, dt, 60)
    r2, T2 = ring_peak(state), 120 * dt

    assert np.isfinite(_np(state.b)).all()
    c_meas = (r2 - r1) / (T2 - T1)
    c_disc = np.sqrt(B0 * hl / 4.0)
    c_isopycnal = np.sqrt(B0 * hl * hl / H2)
    assert abs(c_meas - c_disc) < 0.15 * c_disc, (c_meas, c_disc)
    assert abs(c_meas - c_disc) < abs(c_meas - c_isopycnal), (c_meas, c_disc, c_isopycnal)


def test_blob_crosses_fold():
    """A blob carried north through the seam by a frozen fold-consistent flow keeps
    its content and re-emerges at the mirrored column moving south in index space
    (``tests/test_fold_advection.py``); advection-only Euler steps on the tracer
    tendency."""
    blob_crosses_fold("cpu")


def blob_crosses_fold(device):
    nx, ny = 64, 48
    grid = TripolarGrid.make((nx, ny, 1), dtype=torch.float64, first_pole_longitude=45.0,
                             north_poles_latitude=55.0, device=device)
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=8),
                          device=device)

    j_blob, i_blob, sig = ny - 20, nx // 4, 3.0
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    blob = np.exp(-((jj - j_blob) ** 2 + (ii - i_blob) ** 2) / (2 * sig**2))
    blob = np.where(blob > 1e-10, blob, 0.0)
    c0 = torch.zeros(grid.shape2d, dtype=torch.float64, device=device)
    c0[grid.interior2d] = torch.as_tensor(blob, device=device)
    # northward on the blob's half, southward on the mirrored half: through the seam
    v0 = torch.zeros(grid.shape2d, dtype=torch.float64, device=device)
    v0[grid.interior2d] = torch.as_tensor(np.where(ii < nx // 2, 0.5, -0.5), device=device)
    u0 = torch.zeros(grid.shape2d, dtype=torch.float64, device=device)

    def advect(c, dt):
        S = zipper.fill_halos_batch(torch.stack([u0, v0, c]), [FC, CF, CC], [-1, -1, 1],
                                    grid.Nx, grid.Ny, grid.Hx, grid.Hy)
        _, _, Gc = TH.tendencies(model, S[0], S[1], S[2])
        return c + dt * Gc

    vol = _np(grid.interior(grid.az_cc * model.ib.h_c))
    total0 = float((_np(grid.interior(c0)) * vol).sum())
    dy_min = float(grid.interior(grid.dy_cf).min())
    dt = 0.2 * dy_min / 0.5

    c = c0
    for _ in range(30):  # before the seam row: flux-form conservation is exact
        c = advect(c, dt)
    mid = float((_np(grid.interior(c)) * vol).sum())
    assert abs(mid - total0) / total0 < 1e-8

    for _ in range(2970):  # the full crossing
        c = advect(c, dt)
    ci = _np(grid.interior(c))
    assert np.all(np.isfinite(ci))
    total1 = float((ci * vol).sum())
    assert abs(total1 - total0) / total0 < 1e-6
    jm, im = np.unravel_index(np.argmax(ci), ci.shape)
    assert im == nx - 1 - i_blob, (jm, im)
    assert abs(jm - j_blob) <= 2, (jm, im)
    assert abs(ci.max() - 1.0) < 0.05
