"""Immersed boundary: grid-fitted bottom masking.

Counterpart: ``orthogonalsphericalshellgrids_tpu/grids/immersed.py``
(``make_immersed_boundary``) — ``ImmersedBoundaryGrid(grid,
GridFittedBottom(bottom_height))`` as the reference examples use it to mask the two
north singularities and Antarctica (``examples/bickley_jet.jl:26-29``).

A cell is fluid where ``H = z_top - max(bottom, z_bottom) > 0``; a face is fluid only
if both adjacent cells are. Everything is computed on the host in float64 and cast to
the grid's dtype and device.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..ops import zipper
from ..ops.location import CC
from .tripolar import TripolarGrid

__all__ = ["ImmersedBoundary", "make_immersed_boundary"]

FIELDS = ("bottom", "h_c", "h_u", "h_v", "mask_c", "mask_u", "mask_v")


class ImmersedBoundary(nn.Module):
    """Masks and column depths (halo-inclusive, [y, x]) as registered buffers:
    ``bottom`` (zipper(+1)-filled), ``h_c``/``h_u``/``h_v`` fluid column depths at
    centers and u/v faces, ``mask_c``/``mask_u``/``mask_v`` 1 where fluid."""

    def __init__(self, arrays):
        super().__init__()
        for name in FIELDS:
            self.register_buffer(name, arrays[name])


def make_immersed_boundary(grid: TripolarGrid, bottom_height: Callable | Any) -> ImmersedBoundary:
    """Masks from a bottom-height function ``f(λ, φ)`` evaluated at the grid's cell
    centers (as stored, in the grid's dtype), or from an interior (Ny, Nx) or
    halo-inclusive array."""
    z0, z1 = grid.z_bounds
    shape = grid.shape2d

    if callable(bottom_height):
        lam = grid.interior(grid.lam_cc).cpu().numpy().astype(np.float64)
        phi = grid.interior(grid.phi_cc).cpu().numpy().astype(np.float64)
        bot_int = np.asarray(bottom_height(lam, phi), dtype=np.float64)
        bot_int = np.broadcast_to(bot_int, (grid.Ny, grid.Nx))
    else:
        bot_int = np.asarray(bottom_height, dtype=np.float64)
        if bot_int.shape == shape:
            bot_int = bot_int[grid.interior2d]
        if bot_int.shape != (grid.Ny, grid.Nx):
            raise ValueError(f"bottom_height array has shape {bot_int.shape}, expected "
                             f"{(grid.Ny, grid.Nx)} or {shape}")

    bot = np.full(shape, z1, dtype=np.float64)  # halo default: solid above domain top
    bot[grid.interior2d] = bot_int
    bot = zipper.fill_halos(bot, CC, 1, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
                            south="zero_gradient", inplace=True)

    h_c = np.clip(z1 - np.maximum(bot, z0), 0.0, None)
    h_u = np.minimum(h_c, np.roll(h_c, 1, axis=-1))
    h_v = np.minimum(h_c, np.roll(h_c, 1, axis=-2))
    host = dict(bottom=bot, h_c=h_c, h_u=h_u, h_v=h_v,
                mask_c=(h_c > 0).astype(np.float64),
                mask_u=(h_u > 0).astype(np.float64),
                mask_v=(h_v > 0).astype(np.float64))
    return ImmersedBoundary({k: torch.as_tensor(v).to(device=grid.device, dtype=grid.dtype)
                             for k, v in host.items()})
