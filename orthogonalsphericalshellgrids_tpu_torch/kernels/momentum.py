"""Vector-invariant momentum tendencies: ``csrc/momentum.cu`` and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:momentum_pallas``
without closures, in its two uses: one layer with ``has_mask`` (the single-layer
model) and a layer stack with no lay pack (``models/layered.py:704-710``). The plain
version is the XLA branch of ``models/hydrostatic.py:tendencies`` (lines 664-684),
with the advective mask when the pack has one; it broadcasts over a leading layer
axis.

``static`` is the (10, Yb, Xb) stack ``STATIC_PLANES`` with ``has_mask`` or the
(8, Yb, Xb) stack ``LAYERED_PLANES`` without, shared by every layer.
"""

from __future__ import annotations

import torch

from ..ops.advection import weno5_upwind_centers_from_faces
from ..ops.operators import dxf, dyf, ixc, ixf, iyc, iyf
from . import LAUNCHES, call, check_operands, on_cuda

__all__ = ["momentum", "momentum_plain", "STATIC_PLANES", "LAYERED_PLANES", "REACH"]

STATIC_PLANES = ("dy_cf", "dx_fc", "inv_az_ff", "f_ff", "dx_cf", "inv_dx_fc", "dy_fc",
                 "inv_dy_cf", "mask_u", "mask_v")
LAYERED_PLANES = STATIC_PLANES[:8]
REACH = 5  # the kernel writes 0 within this many cells of the array edge


def momentum_plain(u, v, static, has_mask=True):
    """(Gu, Gv) of halo-filled (Yb, Xb) velocities or (Nz, Yb, Xb) stacks, masked
    by the last two planes of ``static`` with ``has_mask``."""
    dy_cf, dx_fc, inv_az_ff, f_ff, dx_cf, inv_dx_fc, dy_fc, inv_dy_cf = static[:8]
    zeta = (dxf(dy_cf * v) - dyf(dx_fc * u)) * inv_az_ff
    q = zeta + f_ff
    # u-equation (FC): + q̃ v̂ − δxᶠ(K)/Δxᶠᶜ
    v_hat = ixf(iyc(dx_cf * v)) * inv_dx_fc
    q_at_u = weno5_upwind_centers_from_faces(q, v_hat, axis=-2)
    ke = 0.5 * (ixc(u * u) + iyc(v * v))
    Gu = q_at_u * v_hat - dxf(ke) * inv_dx_fc
    # v-equation (CF): − q̃ û − δyᶠ(K)/Δyᶜᶠ
    u_hat = iyf(ixc(dy_fc * u)) * inv_dy_cf
    q_at_v = weno5_upwind_centers_from_faces(q, u_hat, axis=-1)
    Gv = -q_at_v * u_hat - dyf(ke) * inv_dy_cf
    if has_mask:
        Gu = Gu * static[8]
        Gv = Gv * static[9]
    return Gu, Gv


def momentum(u, v, static, has_mask=True):
    """(Gu, Gv) of halo-filled (Yb, Xb) velocities or (Nz, Yb, Xb) stacks: masked,
    with the 10-plane ``static``, when ``has_mask``; unmasked, with the 8-plane
    ``static``, when not. Only cells at least ``REACH`` from the array edge are
    meaningful (the kernel writes 0 there). The launch counts as ``momentum`` with
    the masks and as ``momentum_layered`` without."""
    if u.dim() not in (2, 3):
        raise ValueError(f"momentum takes a (Yb, Xb) plane or an (Nz, Yb, Xb) stack, "
                         f"got shape {tuple(u.shape)}")
    Yb, Xb = u.shape[-2:]
    nz = u.shape[0] if u.dim() == 3 else 1
    n_static = len(STATIC_PLANES if has_mask else LAYERED_PLANES)
    check_operands("momentum", dict(u=u, v=v, static=static), u.dtype,
                   dict(v=u.shape, static=(n_static, Yb, Xb)))
    if not on_cuda(u, v, static):
        return momentum_plain(u, v, static, has_mask)
    Gu = torch.empty_like(u)
    Gv = torch.empty_like(v)
    call("osg_momentum", u.dtype, u.device, u.data_ptr(), v.data_ptr(),
         static.data_ptr(), Gu.data_ptr(), Gv.data_ptr(), nz, Yb, Xb, int(has_mask))
    LAUNCHES["momentum" if has_mask else "momentum_layered"] += 1
    return Gu, Gv
