"""Bickley-jet barotropic turbulence on a tripolar grid, through the PyTorch port.

Mirrors ``examples/bickley_jet.py:build`` (the reference's ``examples/bickley_jet.jl``):
an unstable zonal jet U = sech²(y) with vortical perturbations and a sinusoidal
tracer, WENO-5 vector-invariant momentum + flux-form WENO-5 tracer, split-explicit
free surface, immersed-boundary masking of the two north singularities and
Antarctica — the same masks and initial conditions.

The run is ``examples/bickley_jet.py:main``'s, through the port's ``Simulation``:
50 simulated days from Δt = 60 s with a CFL-0.3 wizard (max Δt 3 h), the progress
line every 10 iterations and daily output of u, v, c and ζ.

Run:  python examples/bickley_jet_torch.py [--nx 180 --ny 90 --days 50 --device cuda]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def build(nx=180, ny=90, dtype=torch.float32, substeps=30, *, device="cuda",
          first_pole_longitude=45.0, north_poles_latitude=25.0, **model_kwargs):
    """(model, state) of the Bickley jet on an ``nx`` x ``ny`` tripolar grid with
    halo 5, on ``device`` in ``dtype``."""
    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import (
        SplitExplicitFreeSurface, initial_state, make_model)

    grid = TripolarGrid.make(
        (nx, ny, 1), halo=(5, 5, 5),
        first_pole_longitude=first_pole_longitude,
        north_poles_latitude=north_poles_latitude,
        dtype=dtype, device=device)

    lam_p, phi_p = first_pole_longitude, north_poles_latitude

    def bottom(lam, phi):
        # mask the singularities and Antarctica (examples/bickley_jet.jl:27-29)
        land = (
            ((np.abs(lam - lam_p) < 5) & (np.abs(phi_p - phi) < 5))
            | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 5) & (np.abs(phi_p - phi) < 5))
            | (phi < -78)
        )
        return np.where(land, 1.0, 0.0)

    model = make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
                       bottom_height=bottom, device=device, **model_kwargs)

    # initial conditions (examples/bickley_jet.jl:57-73)
    eps, ell, k = 0.1, 0.5, 2.5

    def psit(x, y):
        return np.exp(-((y + ell / 10) ** 2) / (2 * ell**2)) * np.cos(k * x) * np.cos(k * y)

    def ui(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 8
        return 1.0 / np.cosh(y) ** 2 + eps * psit(x, y) * (k * np.tan(k * y) + y / ell**2)

    def vi(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 4
        return -eps * psit(x, y) * k * np.tan(k * x)

    def ci(lam, phi):
        return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0)

    state = initial_state(model, u=ui, v=vi, c=ci)
    return model, state


def diagnostics(model, state):
    """(kinetic energy, enstrophy, tracer variance) area integrals over the interior —
    the invariant curves of ``benchmarks/gen_parity_oracle.py:diagnostics``."""
    from orthogonalsphericalshellgrids_tpu_torch.models.diagnostics import (
        vertical_vorticity)

    g = model.grid
    zeta = vertical_vorticity(model, state)
    az = g.az_cc * model.ib.mask_c
    I = g.interior2d
    # the interior of u and v needs no halo fill
    ke = float(torch.sum((0.5 * (state.u**2 + state.v**2) * az)[I]))
    ens = float(torch.sum((zeta**2 * g.az_ff)[I]))
    cvar = float(torch.sum((state.c**2 * az)[I]))
    return ke, ens, cvar


def make_simulation(model, state, days=50.0, dt=60.0, out=None, log=print):
    """The reference's run (``examples/bickley_jet.jl:73-89``, as
    ``examples/bickley_jet.py:main`` sets it up): ``days`` simulated days from Δt =
    ``dt`` with a CFL-0.3 wizard (max change 1.1, max Δt 3 h) and the progress line
    every 10 iterations, and u, v, c and ζ written to ``out`` every simulated day
    (no output when ``out`` is None)."""
    from orthogonalsphericalshellgrids_tpu_torch.models.diagnostics import (
        vertical_vorticity)
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        IterationInterval, OutputWriter, Simulation, TimeInterval, TimeStepWizard,
        progress_callback)

    sim = Simulation(model, state, dt=dt, stop_time=days * 86400.0)
    wizard = TimeStepWizard(cfl=0.3, max_change=1.1, max_dt=3 * 3600.0)
    sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                     IterationInterval(10))
    sim.add_callback(progress_callback(log), IterationInterval(10))
    if out is not None:
        writer = OutputWriter(out, {
            "u": lambda s: s.state.u,
            "v": lambda s: s.state.v,
            "c": lambda s: s.state.c,
            "zeta": lambda s: vertical_vorticity(s.model, s.state),
        })
        sim.add_callback(writer, TimeInterval(86400.0))
    return sim


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=180)
    p.add_argument("--ny", type=int, default=90)
    p.add_argument("--days", type=float, default=50.0)
    p.add_argument("--dt", type=float, default=60.0)
    p.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    p.add_argument("--out", default="tripolar_bickley.npz")
    args = p.parse_args(argv)

    model, state = build(args.nx, args.ny, device=args.device)
    sim = make_simulation(model, state, args.days, args.dt, args.out)
    sim.run()
    ke, ens, cvar = diagnostics(model, sim.state)
    print(f"done: iter={sim.iteration} t={sim.time / 86400:.1f} days on {args.device}: "
          f"ke={ke:.6e} ens={ens:.6e} cvar={cvar:.6e} -> {args.out}")


if __name__ == "__main__":
    main()
