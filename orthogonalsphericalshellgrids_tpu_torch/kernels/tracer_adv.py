"""Flux-form WENO-5 tracer advection: ``csrc/tracer_adv.cu`` and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:tracer_adv_pallas``
(column mode, S = 3). The plain version is ``models/hydrostatic.py:698-702``.

``static`` is the (5, Yb, Xb) stack ``STATIC_PLANES`` on the base grid:
``inv_vol_c = mask_c / (Az_cc h_c)``.
"""

from __future__ import annotations

import torch

from ..ops.advection import weno5_upwind_faces_from_centers
from ..ops.operators import dxc, dyc
from . import LAUNCHES, call, check_operands, on_cuda

__all__ = ["tracer_adv", "tracer_adv_plain", "STATIC_PLANES", "REACH"]

STATIC_PLANES = ("h_u", "dy_fc", "h_v", "dx_cf", "inv_vol_c")
REACH = 4  # the kernel writes 0 within this many cells of the array edge


def tracer_adv_plain(c, u, v, static):
    """G = -(δx(u h_u Δy cx) + δy(v h_v Δx cy)) · mask_c/(Az h_c) of halo-filled
    (Yb, Xb) fields."""
    h_u, dy_fc, h_v, dx_cf, inv_vol_c = static
    cx = weno5_upwind_faces_from_centers(c, u, axis=-1)
    cy = weno5_upwind_faces_from_centers(c, v, axis=-2)
    fx = u * h_u * dy_fc * cx
    fy = v * h_v * dx_cf * cy
    return -(dxc(fx) + dyc(fy)) * inv_vol_c


def tracer_adv(c, u, v, static):
    """The tracer tendency of halo-filled (Yb, Xb) fields; only cells at least
    ``REACH`` from the array edge are meaningful (the kernel writes 0 there)."""
    Yb, Xb = c.shape
    check_operands("tracer_adv", dict(c=c, u=u, v=v, static=static), c.dtype,
                   dict(u=(Yb, Xb), v=(Yb, Xb), static=(len(STATIC_PLANES), Yb, Xb)))
    if not on_cuda(c, u, v, static):
        return tracer_adv_plain(c, u, v, static)
    G = torch.empty_like(c)
    call("osg_tracer_adv", c.dtype, c.device, c.data_ptr(), u.data_ptr(), v.data_ptr(),
         static.data_ptr(), G.data_ptr(), Yb, Xb)
    LAUNCHES["tracer_adv"] += 1
    return G
