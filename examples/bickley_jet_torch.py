"""Bickley-jet barotropic turbulence on a tripolar grid, through the PyTorch port.

Mirrors ``examples/bickley_jet.py:build`` (the reference's ``examples/bickley_jet.jl``):
an unstable zonal jet U = sech²(y) with vortical perturbations and a sinusoidal
tracer, WENO-5 vector-invariant momentum + flux-form WENO-5 tracer, split-explicit
free surface, immersed-boundary masking of the two north singularities and
Antarctica — the same masks and initial conditions.

Run:  python examples/bickley_jet_torch.py --device cuda [--nx 1440 --ny 680 --steps 20]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build(nx=180, ny=90, dtype=torch.float32, substeps=30, *, device,
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
    from orthogonalsphericalshellgrids_tpu_torch.models.hydrostatic import vorticity
    from orthogonalsphericalshellgrids_tpu_torch.ops import zipper
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CF, FC

    g = model.grid
    u = zipper.fill_halos(state.u, FC, -1, g.Nx, g.Ny, g.Hx, g.Hy)
    v = zipper.fill_halos(state.v, CF, -1, g.Nx, g.Ny, g.Hx, g.Hy)
    zeta = vorticity(model, u, v)
    az = g.az_cc * model.ib.mask_c
    I = g.interior2d
    ke = float(torch.sum((0.5 * (u**2 + v**2) * az)[I]))
    ens = float(torch.sum((zeta**2 * g.az_ff)[I]))
    cvar = float(torch.sum((state.c**2 * az)[I]))
    return ke, ens, cvar


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=180)
    p.add_argument("--ny", type=int, default=90)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dt", type=float, default=60.0)
    p.add_argument("--device", required=True, help="cpu | cuda")
    args = p.parse_args()

    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step

    model, state = build(args.nx, args.ny, device=args.device)
    state = multi_step(model, state, args.dt, args.steps)
    ke, ens, cvar = diagnostics(model, state)
    print(f"done: {args.steps} steps on {args.device}: ke={ke:.6e} ens={ens:.6e} "
          f"cvar={cvar:.6e}")


if __name__ == "__main__":
    main()
