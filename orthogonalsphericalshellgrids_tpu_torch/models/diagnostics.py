"""Diagnostics: vertical vorticity, kinetic energy, conserved integrals, CFL numbers.

Counterpart: ``orthogonalsphericalshellgrids_tpu/models/diagnostics.py``, function for
function and in the same arithmetic order. Each is a plain function of (model, state)
returning tensors on the model's device; the fills go through the halo-fill kernel on
a card, like the step's.
"""

from __future__ import annotations

import torch

from ..ops.location import CF, FC
from ..ops.operators import ixc, iyc
from .hydrostatic import HydrostaticModel, State, _fill, vorticity

__all__ = ["vertical_vorticity", "kinetic_energy", "max_speeds", "advective_cfl",
           "tracer_content", "surface_volume", "layered_tracer_content", "seam_row_weights"]


def vertical_vorticity(model: HydrostaticModel, state: State):
    """ζ at FF from the prognostic velocities (halo-filled here): the reference's
    VerticalVorticityField."""
    g = model.grid
    u = _fill(g, state.u, FC, -1)
    v = _fill(g, state.v, CF, -1)
    return vorticity(model, u, v)


def kinetic_energy(model: HydrostaticModel, state: State):
    """KE per unit mass at cell centers: (ℑx(u²) + ℑy(v²)) / 2."""
    g = model.grid
    u = _fill(g, state.u, FC, -1)
    v = _fill(g, state.v, CF, -1)
    return 0.5 * (ixc(u * u) + iyc(v * v)) * model.ib.mask_c


def seam_row_weights(Ny, dtype=None, device=None):
    """(Ny, 1) row weights for global integrals on a tripolar grid: the last interior
    row (the fold seam) appears twice in index space, so it is counted at weight 1/2
    (``src/zipper_boundary_condition.jl:95-104``)."""
    w = torch.ones((Ny, 1), dtype=dtype, device=device)
    w[-1, 0] = 0.5
    return w


def tracer_content(model: HydrostaticModel, state: State):
    """Global tracer content Σ c·Az·H with the seam row half-weighted, conserved to
    round-off by the flux-form advection across the fold; with several tracers (a
    stacked ``state.c``) the per-tracer vector in ``model.tracer_names`` order."""
    g = model.grid
    w = seam_row_weights(g.Ny, model.dtype, model.device)
    return torch.sum(g.interior(state.c * g.az_cc * model.ib.h_c) * w, dim=(-2, -1))


def surface_volume(model: HydrostaticModel, state: State):
    """Global free-surface volume anomaly Σ η·Az (seam row half-weighted), conserved
    by the barotropic divergence update."""
    ge = model.grid_ext
    w = seam_row_weights(ge.Ny, model.dtype, model.device)
    return torch.sum(ge.interior(state.eta * ge.az_cc) * w)


def layered_tracer_content(model, state, field="c"):
    """Σ c·Az·dz over all layers (seam row half-weighted), the layered model's
    conserved tracer functional. With several tracers (``field="c"``) returns the
    per-tracer vector in ``model.tracer_names`` order."""
    from .layered import _as_tracer4

    g = model.grid
    w = seam_row_weights(g.Ny, model.dtype, model.device)
    c = getattr(state, field)
    vol = model.mask_c3 * model.dz3 * g.az_cc
    if field == "c":
        c4 = _as_tracer4(model, c)
        out = torch.sum(g.interior(c4 * vol) * w, dim=(-3, -2, -1))
        return out[0] if len(model.tracer_names) == 1 else out
    return torch.sum(g.interior(c * vol) * w)


def max_speeds(model: HydrostaticModel, state: State):
    """(max|u|, max|v|) over the interior, the progress readout."""
    g = model.grid
    return (torch.max(torch.abs(g.interior(state.u))),
            torch.max(torch.abs(g.interior(state.v))))


def advective_cfl(model: HydrostaticModel, state: State, dt):
    """max over cells of (|u|/Δx + |v|/Δy)·Δt."""
    g = model.grid
    speed = torch.abs(state.u) * model.inv_dx_fc + torch.abs(state.v) * model.inv_dy_cf
    return torch.max(g.interior(speed)) * dt
