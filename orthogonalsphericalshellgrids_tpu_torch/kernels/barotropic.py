"""The split-explicit barotropic subcycle: ``csrc/barotropic.cu`` and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_baro.py:
barotropic_substeps_pallas``. The plain version is the XLA scan of
``models/hydrostatic.py:barotropic_substeps`` (lines 948-972) written as a Python
loop; the kernel follows it term for term (dtau is not folded into the factors).

``static`` is the (9, Ye, Xe) stack ``STATIC_PLANES`` on the extended-halo grid.
"""

from __future__ import annotations

import torch

from ..ops import zipper
from ..ops.operators import dxc, dxf, dyc, dyf
from . import LAUNCHES, call, check_operands, on_cuda

__all__ = ["barotropic_substeps", "barotropic_substeps_plain", "STATIC_PLANES"]

STATIC_PLANES = ("dy_fc", "dx_cf", "inv_az_cc", "gh_u", "gh_v", "inv_dx_fc",
                 "inv_dy_cf", "mask_u", "mask_v")


def barotropic_substeps_plain(static, eta, U, V, GU, GV, dtau, weights, Nx, Hx,
                              wrap_x_each_substep=True):
    """SM05-averaged forward-backward substeps of (η, U, V); returns the averages.
    ``dtau`` is a 0-d tensor, ``weights`` the 1-D SM05 weights (one per substep)."""
    dy_fc, dx_cf, inv_az, gH_u, gH_v, inv_dx, inv_dy, mask_u, mask_v = static

    def wrapx(A):
        return zipper.wrap_x(A, Nx, Hx) if wrap_x_each_substep else A

    eta_a, U_a, V_a = (torch.zeros_like(a) for a in (eta, U, V))
    for m in range(weights.shape[0]):
        w = weights[m]
        div = (dxc(dy_fc * U) + dyc(dx_cf * V)) * inv_az
        eta = wrapx(eta - dtau * div)
        U = wrapx((U - dtau * (gH_u * dxf(eta) * inv_dx - GU)) * mask_u)
        V = wrapx((V - dtau * (gH_v * dyf(eta) * inv_dy - GV)) * mask_v)
        eta_a, U_a, V_a = eta_a + w * eta, U_a + w * U, V_a + w * V
    return eta_a, U_a, V_a


def barotropic_substeps(static, eta, U, V, GU, GV, dtau, weights, Nx, Hx,
                        wrap_x_each_substep=True):
    """The barotropic subcycle; inputs are not modified. On a CUDA device one C
    entry call runs all ``len(weights)`` substeps as two launches each on the
    current stream. Cells whose stencil leaves the array come out 0 from the kernel
    and wrapped garbage from the plain version: validity shrinks by one cell per
    substep from the array edge, as in the JAX package."""
    Ye, Xe = eta.shape
    dt = eta.dtype
    n_sub = weights.shape[0]
    check_operands(
        "barotropic_substeps",
        dict(static=static, eta=eta, U=U, V=V, GU=GU, GV=GV, dtau=dtau, weights=weights),
        dt, dict(static=(len(STATIC_PLANES), Ye, Xe), U=(Ye, Xe), V=(Ye, Xe),
                 GU=(Ye, Xe), GV=(Ye, Xe), dtau=(), weights=(n_sub,)))
    if n_sub < 1:
        raise ValueError("barotropic_substeps needs at least one weight")
    if not on_cuda(static, eta, U, V, GU, GV, dtau, weights):
        return barotropic_substeps_plain(static, eta, U, V, GU, GV, dtau, weights, Nx,
                                         Hx, wrap_x_each_substep)
    work = torch.empty((6, Ye, Xe), dtype=dt, device=eta.device)
    acc = torch.empty((3, Ye, Xe), dtype=dt, device=eta.device)
    call("osg_barotropic", dt, eta.device, static.data_ptr(), eta.data_ptr(),
         U.data_ptr(), V.data_ptr(), GU.data_ptr(), GV.data_ptr(), work.data_ptr(),
         acc.data_ptr(), dtau.data_ptr(), weights.data_ptr(), int(n_sub), Ye, Xe, Nx, Hx,
         int(wrap_x_each_substep))
    LAUNCHES["barotropic"] += 1
    return acc[0], acc[1], acc[2]
