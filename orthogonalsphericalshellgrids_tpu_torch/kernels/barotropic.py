"""The split-explicit barotropic subcycle: ``csrc/barotropic.cu`` and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_baro.py:
barotropic_substeps_pallas``. The plain version is the XLA scan of
``models/hydrostatic.py:barotropic_substeps`` (lines 948-972) written as a Python
loop. The kernel runs the substeps in time tiles (``launch_plan``) and folds dtau
into its factors once, as the TPU kernel does.

``static`` is the (9, Ye, Xe) stack ``STATIC_PLANES`` on the extended-halo grid.

Members (an ensemble, ``models/ensemble.py``; the counterpart of ``jax.vmap`` over
the TPU kernel): η, U, V, GU and GV may be (B, Ye, Xe) stacks of B members sharing
``static``, ``dtau`` and the weights. One C entry call runs every member in each
launch of the plan, and returns (B, Ye, Xe) averages, each member bitwise its own
one-member call.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops import zipper
from ..ops.operators import dxc, dxf, dyc, dyf
from . import call, check_operands, count, on_cuda, output, placed

__all__ = ["barotropic_substeps", "barotropic_substeps_plain", "launch_plan",
           "STATIC_PLANES"]

STATIC_PLANES = ("dy_fc", "dx_cf", "inv_az_cc", "gh_u", "gh_v", "inv_dx_fc",
                 "inv_dy_cf", "mask_u", "mask_v")

# The window of one CTA of csrc/barotropic.cu for each dtype, (columns, thread rows,
# rows a thread owns): the source holds the same numbers and refuses a plan that
# assumed others. K_MAX caps the substeps of one launch, and so the ring's width: two
# launches of 11 ran 2 % faster than three of 7 on the H100 at float32; the float64
# window is narrower, so its ring stays at 7.
WINDOW = {torch.float32: (64, 8, 6), torch.float64: (32, 8, 4)}
K_MAX = {torch.float32: 11, torch.float64: 7}
_K_LIMIT = 16  # the source's bound on the substeps of a launch (its weights' buffer)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``barotropic_substeps`` runs on the card: ``launches`` are the substep
    ranges [m0, m1) of its launches, in order; each launch runs every tile of the
    (rows, columns) ``grid``, one CTA of ``threads`` threads loading a ``window`` of
    its ``tile`` plus a ring of ``k`` cells, with ``smem_bytes`` of shared memory."""

    k: int
    launches: tuple
    window: tuple
    tile: tuple
    grid: tuple
    threads: int
    smem_bytes: int


def _plan(Ye, Xe, n_sub, window, k_max, itemsize):
    WX, NTY, PT = window
    WY = NTY * PT
    n_launch = -(-n_sub // k_max)
    k = -(-n_sub // n_launch)
    TY, TX = WY - 2 * k, WX - 2 * k
    # fx and eta over the window, the y-flux of each thread's first row, the seam's
    # two columns and the launch's weights
    smem = (2 * WY * WX + NTY * WX + 2 * WY + _K_LIMIT) * itemsize
    return LaunchPlan(k=k, launches=tuple((m0, min(m0 + k, n_sub))
                                          for m0 in range(0, n_sub, k)),
                      window=(WY, WX), tile=(TY, TX), grid=(-(-Ye // TY), -(-Xe // TX)),
                      threads=WX * NTY, smem_bytes=smem)


@functools.lru_cache(maxsize=64)
def launch_plan(Ye, Xe, n_sub, dtype):
    """The launch plan for an (Ye, Xe) plane and ``n_sub`` substeps: the fewest
    launches of at most ``K_MAX[dtype]`` substeps, balanced, so that the ring is as
    narrow as that count allows."""
    if n_sub < 1:
        raise ValueError("barotropic_substeps needs at least one weight")
    return _plan(Ye, Xe, n_sub, WINDOW[dtype], K_MAX[dtype],
                 torch.empty((), dtype=dtype).element_size())


def barotropic_substeps_plain(static, eta, U, V, GU, GV, dtau, weights, Nx, Hx,
                              wrap_x_each_substep=True):
    """SM05-averaged forward-backward substeps of (η, U, V); returns the averages.
    ``dtau`` is a 0-d tensor, ``weights`` the 1-D SM05 weights (one per substep).
    Broadcasts over a leading member axis of the state and forcing."""
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
                        wrap_x_each_substep=True, out=None):
    """The barotropic subcycle of one (Ye, Xe) state or a (B, Ye, Xe) stack of
    members; inputs are not modified. On a CUDA device one C entry call runs the
    ``len(weights)`` substeps as the launches of ``launch_plan`` on the current
    stream, every member in each launch. Validity shrinks by one cell per substep
    from the array edge, as in the JAX package: beyond it the kernel's cells hold
    finite values of no meaning and the plain version's wrapped garbage. Returns the
    averages (η, U, V); ``out``, a (3,) + η.shape buffer, receives them in place of a
    new one (they are its views)."""
    if eta.dim() not in (2, 3) or eta.numel() == 0:
        raise ValueError(f"barotropic_substeps takes a (Ye, Xe) plane or a (B, Ye, Xe) "
                         f"member stack, got shape {tuple(eta.shape)}")
    Ye, Xe = eta.shape[-2:]
    n_members = eta.shape[0] if eta.dim() == 3 else 1
    dt = eta.dtype
    n_sub = weights.shape[0]
    check_operands(
        "barotropic_substeps",
        dict(static=static, eta=eta, U=U, V=V, GU=GU, GV=GV, dtau=dtau, weights=weights),
        dt, dict(static=(len(STATIC_PLANES), Ye, Xe), U=eta.shape, V=eta.shape,
                 GU=eta.shape, GV=eta.shape, dtau=(), weights=(n_sub,)))
    if n_sub < 1:
        raise ValueError("barotropic_substeps needs at least one weight")
    if not on_cuda(static, eta, U, V, GU, GV, dtau, weights):
        avg = barotropic_substeps_plain(static, eta, U, V, GU, GV, dtau, weights, Nx, Hx,
                                        wrap_x_each_substep)
        if out is None:
            return avg
        placed("barotropic_substeps", torch.stack(avg), out)
        return out[0], out[1], out[2]
    if wrap_x_each_substep and not (1 <= Hx <= Nx and Xe == Nx + 2 * Hx):
        raise ValueError(f"the x-wrap needs Xe = Nx + 2 Hx with 1 <= Hx <= Nx, got "
                         f"Xe={Xe}, Nx={Nx}, Hx={Hx}")
    plan = launch_plan(Ye, Xe, n_sub, dt)
    n_work = min(len(plan.launches) - 1, 2)
    # each work set and the averages are (3, B, Ye, Xe): component-major, so that
    # each average is one contiguous member stack
    work = torch.empty((3 * n_work,) + eta.shape, dtype=dt, device=eta.device)
    acc = output("barotropic_substeps", eta, out, (3,) + eta.shape)
    call("osg_barotropic", dt, eta.device, static.data_ptr(), eta.data_ptr(),
         U.data_ptr(), V.data_ptr(), GU.data_ptr(), GV.data_ptr(), work.data_ptr(),
         acc.data_ptr(), dtau.data_ptr(), weights.data_ptr(), int(n_sub), n_members, Ye,
         Xe, Nx, Hx, int(wrap_x_each_substep), plan.k, plan.window[1], plan.window[0])
    count("barotropic")
    return acc[0], acc[1], acc[2]
