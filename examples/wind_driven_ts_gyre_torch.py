"""Wind-driven stratified gyres with T/S thermodynamics, through the PyTorch port's
layered engine.

Mirrors ``examples/wind_driven_ts_gyre.py:build``: a meridional continental barrier
closes the x-periodic tripolar domain into a basin, and steady zonal wind stress
(easterly trades, mid-latitude westerlies) spins up gyres. Temperature and salinity
are active tracers through the linear seawater equation of state, the layers are
stretched (each about 1.7 times the one above), and the momentum budget carries
Coriolis, quadratic bottom drag (Cd = 2.5e-3), ν_h = 5e3 and κ_h = 1e2 m²/s, and
ν_v = 1e-3 and κ_v = 1e-5 m²/s. ``bench_layered.py`` runs this configuration at
1440 x 680 x 10 with substeps = 30 and dt = 40 s.

Run:  python examples/wind_driven_ts_gyre_torch.py --device cuda [--nx 1440 --ny 680 --nz 10]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build(nx=180, ny=80, nz=6, dtype=torch.float32, substeps=20, *, device,
          first_pole_longitude=70.0, north_poles_latitude=55.0, depth=2000.0,
          **model_kwargs):
    """(model, state) of the gyre on an ``nx`` x ``ny`` x ``nz`` tripolar grid with
    halo 5, on ``device`` in ``dtype``; ``model_kwargs`` go to
    ``make_layered_model``."""
    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, layered_initial_state, make_layered_model)

    # stretched layers: geometric taper (each layer ~1.7x the one above), any nz
    frac = 1.7 ** np.arange(nz, dtype=np.float64)
    frac = frac / frac.sum()
    z_faces = -depth + depth * np.concatenate([[0.0], np.cumsum(frac[::-1])])
    grid = TripolarGrid.make(
        (nx, ny, nz), halo=(5, 5, 5), z=z_faces,
        first_pole_longitude=first_pole_longitude,
        north_poles_latitude=north_poles_latitude, dtype=dtype, device=device)
    lam_p, phi_p = first_pole_longitude, north_poles_latitude

    def bottom(lam, phi):
        # pole singularity masks + Antarctica + a meridional continental barrier
        # (20 degrees wide at lam_p + 90) that closes the basin
        barrier_lon = (lam_p + 90.0) % 360.0
        dlon = np.minimum(np.abs(lam - barrier_lon), 360.0 - np.abs(lam - barrier_lon))
        land = (
            ((np.abs(lam - lam_p) < 8) & (np.abs(phi_p - phi) < 8))
            | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 8) & (np.abs(phi_p - phi) < 8))
            | (phi < -78)
            | ((dlon < 10.0) & (phi > -70) & (phi < 70))
        )
        return np.where(land, 1.0, -depth)

    def wind(lam, phi):
        # idealized zonal stress: easterly trades, westerlies poleward of ~30 degrees
        tau0 = 1e-4  # kinematic stress [m^2/s^2] ~ 0.1 N/m^2 / rho0
        taux = -tau0 * np.cos(np.deg2rad(phi) * 3.0) * np.cos(np.deg2rad(phi))
        return taux, np.zeros_like(taux)

    model = make_layered_model(
        grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
        bottom_height=bottom, tracers=("T", "S"), buoyancy="linear_eos", coriolis=True,
        wind_stress=wind, bottom_drag=("quadratic", 2.5e-3), nu_h=5e3, kappa_h=1e2,
        nu_v=1e-3, kappa_v=1e-5, device=device, **model_kwargs)

    # warm/salty subtropics, cold/fresh poles; surface-intensified stratification
    def Ti(lam, phi, z):
        return 4.0 + 16.0 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 500.0)

    def Si(lam, phi, z):
        return 34.0 + 1.5 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 800.0)

    state = layered_initial_state(model, c={"T": Ti, "S": Si})
    return model, state


CHECK_LAM_P, CHECK_PHI_P = 45.0, 25.0


def check_bottom(lam, phi):
    """The bottom of the small check gyre: the two north singularities and
    Antarctica masked, 1000 m elsewhere."""
    land = (((np.abs(lam - CHECK_LAM_P) < 10) & (np.abs(CHECK_PHI_P - phi) < 10))
            | ((np.abs(lam - (CHECK_LAM_P + 180.0)) < 10) & (np.abs(CHECK_PHI_P - phi) < 10))
            | (phi < -78))
    return np.where(land, 1.0, -1000.0)


def check_wind(lam, phi):
    return 1e-4 * np.cos(np.deg2rad(phi)), np.zeros_like(lam)


CHECK_OPTIONS = dict(tracers=("T", "S"), buoyancy="linear_eos", coriolis=True,
                     wind_stress=check_wind, bottom_drag=("quadratic", 2.5e-3),
                     nu_h=5e3, kappa_h=1e2, nu_v=1e-3, kappa_v=1e-5)
CHECK_INIT = dict(
    u=lambda lam, phi, z: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
    v=lambda lam, phi, z: 0.05 * np.sin(np.deg2rad(lam) * 3),
    c={"T": lambda lam, phi, z: 4.0 + 16.0 * np.cos(np.deg2rad(phi)) ** 2
       * np.exp(z / 500.0),
       "S": lambda lam, phi, z: 34.0 + 1.5 * np.cos(np.deg2rad(phi)) ** 2
       * np.exp(z / 800.0)},
    eta=lambda lam, phi: 0.01 * np.cos(np.deg2rad(lam) * 2))


def build_check(nz=3, dtype=torch.float64, *, device):
    """(model, state) of the small gyre that the JAX package's kernel-path tests run
    (``tests/test_layered_kernels.py:45-81``): 48 x 32 x ``nz`` uniform layers over
    1000 m, substeps = 6, the gyre's options (``CHECK_OPTIONS``) and initial state
    (``CHECK_INIT``)."""
    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, layered_initial_state, make_layered_model)

    grid = TripolarGrid.make((48, 32, nz), z=(-1000.0, 0.0),
                             first_pole_longitude=CHECK_LAM_P,
                             north_poles_latitude=CHECK_PHI_P, dtype=dtype, device=device)
    model = make_layered_model(grid, free_surface=SplitExplicitFreeSurface(substeps=6),
                               bottom_height=check_bottom, device=device, **CHECK_OPTIONS)
    return model, layered_initial_state(model, **CHECK_INIT)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=180)
    p.add_argument("--ny", type=int, default=80)
    p.add_argument("--nz", type=int, default=6)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dt", type=float, default=300.0)
    p.add_argument("--device", required=True, help="cpu | cuda")
    args = p.parse_args()

    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    model, state = build(args.nx, args.ny, args.nz, device=args.device)
    state = layered_multi_step(model, state, args.dt, args.steps)
    nz = model.nz
    print(f"done: {args.steps} steps on {args.device}: max|u| "
          f"{float(state.u.abs().max()):.6e}, surface T in "
          f"[{float(state.c[0].min()):.4f}, {float(state.c[0].max()):.4f}], surface S in "
          f"[{float(state.c[nz].min()):.4f}, {float(state.c[nz].max()):.4f}]")


if __name__ == "__main__":
    main()
