"""Vector-invariant momentum tendencies: ``csrc/momentum.cu`` and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:momentum_pallas``
(one layer, ``has_mask``, no closures). The plain version is the XLA branch of
``models/hydrostatic.py:tendencies`` (lines 664-684) with the advective mask.

``static`` is the (10, Yb, Xb) stack ``STATIC_PLANES`` on the base grid.
"""

from __future__ import annotations

import torch

from ..ops.advection import weno5_upwind_centers_from_faces
from ..ops.operators import dxf, dyf, ixc, ixf, iyc, iyf
from . import LAUNCHES, call, check_operands, on_cuda

__all__ = ["momentum", "momentum_plain", "STATIC_PLANES", "REACH"]

STATIC_PLANES = ("dy_cf", "dx_fc", "inv_az_ff", "f_ff", "dx_cf", "inv_dx_fc", "dy_fc",
                 "inv_dy_cf", "mask_u", "mask_v")
REACH = 5  # the kernel writes 0 within this many cells of the array edge


def momentum_plain(u, v, static):
    """(Gu, Gv) of halo-filled (Yb, Xb) velocities."""
    dy_cf, dx_fc, inv_az_ff, f_ff, dx_cf, inv_dx_fc, dy_fc, inv_dy_cf, mask_u, mask_v = static
    zeta = (dxf(dy_cf * v) - dyf(dx_fc * u)) * inv_az_ff
    q = zeta + f_ff
    # u-equation (FC): + q̃ v̂ − δxᶠ(K)/Δxᶠᶜ
    v_hat = ixf(iyc(dx_cf * v)) * inv_dx_fc
    q_at_u = weno5_upwind_centers_from_faces(q, v_hat, axis=-2)
    ke = 0.5 * (ixc(u * u) + iyc(v * v))
    Gu = (q_at_u * v_hat - dxf(ke) * inv_dx_fc) * mask_u
    # v-equation (CF): − q̃ û − δyᶠ(K)/Δyᶜᶠ
    u_hat = iyf(ixc(dy_fc * u)) * inv_dy_cf
    q_at_v = weno5_upwind_centers_from_faces(q, u_hat, axis=-1)
    Gv = (-q_at_v * u_hat - dyf(ke) * inv_dy_cf) * mask_v
    return Gu, Gv


def momentum(u, v, static):
    """(Gu, Gv) of halo-filled (Yb, Xb) velocities; only cells at least ``REACH``
    from the array edge are meaningful (the kernel writes 0 there)."""
    Yb, Xb = u.shape
    check_operands("momentum", dict(u=u, v=v, static=static), u.dtype,
                   dict(v=(Yb, Xb), static=(len(STATIC_PLANES), Yb, Xb)))
    if not on_cuda(u, v, static):
        return momentum_plain(u, v, static)
    Gu = torch.empty_like(u)
    Gv = torch.empty_like(v)
    call("osg_momentum", u.dtype, u.device, u.data_ptr(), v.data_ptr(),
         static.data_ptr(), Gu.data_ptr(), Gv.data_ptr(), Yb, Xb)
    LAUNCHES["momentum"] += 1
    return Gu, Gv
