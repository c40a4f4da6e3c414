"""Baroclinic front adjustment on a tripolar grid, through the PyTorch port's layered
engine.

Mirrors ``examples/baroclinic_front.py:build``: a mid-latitude buoyancy front (light
water to the south, dense to the north, over a stable stratification) adjusts under
rotation. Prognostic buoyancy ``b`` and one passive tracer, Coriolis, explicit
ν_v = 1e-4 and κ_v = 1e-5 m²/s, uniform layers over a 1000 m column, the same
bottom (the two north singularities and Antarctica masked) and the same initial
front.

The run is ``examples/baroclinic_front.py:main``'s, through the port's
``Simulation``: 10 simulated days with a CFL-0.25 wizard and daily output.

Run:  python examples/baroclinic_front_torch.py [--nx 120 --ny 60 --nz 8 --days 10 --device cuda]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build(nx=120, ny=60, nz=8, dtype=torch.float32, substeps=20, *, device="cuda",
          depth=1000.0, first_pole_longitude=70.0, north_poles_latitude=55.0):
    """(model, state) of the front on an ``nx`` x ``ny`` x ``nz`` tripolar grid with
    halo 5, on ``device`` in ``dtype``."""
    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, layered_initial_state, make_layered_model)

    grid = TripolarGrid.make(
        (nx, ny, nz), halo=(5, 5, 5), z=(-depth, 0.0),
        first_pole_longitude=first_pole_longitude,
        north_poles_latitude=north_poles_latitude, dtype=dtype, device=device)
    lam_p, phi_p = first_pole_longitude, north_poles_latitude

    def bottom(lam, phi):
        land = (
            ((np.abs(lam - lam_p) < 8) & (np.abs(phi_p - phi) < 8))
            | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 8) & (np.abs(phi_p - phi) < 8))
            | (phi < -78)
        )
        return np.where(land, 1.0, -depth)

    model = make_layered_model(
        grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
        bottom_height=bottom, buoyancy=True, coriolis=True, nu_v=1e-4, kappa_v=1e-5,
        device=device)

    # stable stratification N² = 1e-5 s⁻² plus a tanh buoyancy front at 30°N,
    # surface-intensified (decays over the top half of the column)
    N2, db, phi0, dphi = 1e-5, 2e-3, 30.0, 5.0

    def bi(lam, phi, z):
        front = -0.5 * db * np.tanh((phi - phi0) / dphi)
        return N2 * z + front * np.exp(z / (0.5 * depth))

    state = layered_initial_state(model, b=bi)
    return model, state


def kinetic_energy(model, state):
    """Σ ½ (u² + v²) dz · Az over the wet interior, the front oracle's KE curve
    (``tests/test_parity.py:229-230``)."""
    g = model.grid
    az = g.az_cc * model.baro.ib.mask_c
    ke = 0.5 * torch.sum((state.u ** 2 + state.v ** 2) * model.dz3, dim=0) * az
    return float(torch.sum(g.interior(ke)))


def make_simulation(model, state, days=10.0, dt=120.0, out=None, log=print):
    """``examples/baroclinic_front.py:main``'s run: ``days`` simulated days from Δt =
    ``dt`` with a CFL-0.25 wizard (max change 1.1, max Δt 30 min) every 10
    iterations, the progress line every 20, and the surface and bottom u, the
    surface b and η written to ``out`` every simulated day (none when ``out`` is
    None)."""
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        IterationInterval, OutputWriter, Simulation, TimeInterval, TimeStepWizard,
        progress_callback)

    sim = Simulation(model, state, dt=dt, stop_time=days * 86400.0)
    wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=1800.0)
    sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                     IterationInterval(10))
    sim.add_callback(progress_callback(log), IterationInterval(20))
    if out is not None:
        writer = OutputWriter(out, {
            "u_surface": lambda s: s.state.u[0],
            "u_bottom": lambda s: s.state.u[-1],
            "b_surface": lambda s: s.state.b[0],
            "eta": lambda s: s.state.eta,
        })
        sim.add_callback(writer, TimeInterval(86400.0))
    return sim


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=120)
    p.add_argument("--ny", type=int, default=60)
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--days", type=float, default=10.0)
    p.add_argument("--dt", type=float, default=120.0)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--out", default="tripolar_baroclinic_front.npz")
    args = p.parse_args(argv)

    model, state = build(args.nx, args.ny, args.nz, device=args.device)
    sim = make_simulation(model, state, args.days, args.dt, args.out)
    sim.run()
    print(f"done: iter={sim.iteration} t={sim.time / 86400:.1f} days on {args.device}: "
          f"ke={kinetic_energy(model, sim.state):.6e} -> {args.out}")


if __name__ == "__main__":
    main()
