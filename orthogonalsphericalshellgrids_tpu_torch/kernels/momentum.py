"""Vector-invariant momentum tendencies: ``csrc/momentum.cu`` and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:momentum_pallas``
with all its operands, in its two uses: one layer with ``has_mask`` (the single-layer
model) and a layer stack without (``models/layered.py:704-710``), each optionally with
the fused ν_h Laplacians (``has_lap``), quadratic bottom drag (``has_drag``), an
additive pair ``acc`` and a closing mask pair ``mask_out``. The plain version is the
kernel's arithmetic (``pallas_mom.py:198-268``) written with the port's operators; it
broadcasts over a leading layer axis.

``static`` is the (10, Yb, Xb) stack ``STATIC_PLANES`` with ``has_mask`` or the
(8, Yb, Xb) stack ``LAYERED_PLANES`` without, shared by every layer. ``lay`` is the
per-layer closure pack, plane ``k·L + i`` the i-th factor of layer k, L = 6·has_lap +
2·has_drag, in the order ``LAP_PLANES`` then ``DRAG_PLANES`` (``pallas_mom.py:288-296``
without the mask planes, which ride in ``static`` here). ``acc`` and ``mask_out`` are
pairs of tensors shaped exactly like ``u`` (``pallas_mom.py:331, 335``).

``period`` (default: the layer count) repeats the closure pack and the closing mask
over the layers: layer k reads their layer k mod period, so ``lay`` holds
period·L planes and ``mask_out`` (period, Yb, Xb). An ensemble runs its members as
layers (``models/ensemble.py``): B layered members as B·Nz layers with period Nz,
B single-layer members as B layers with period 1, one pack and one mask for all;
``acc`` stays per layer.

The kernel runs in tiles (``launch_plan``): each CTA owns a tile of output cells,
loads the metric planes of the tile and its ``REACH`` ring into shared memory once,
and loops over the layers.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops.advection import weno5_upwind_centers_from_faces
from ..ops.operators import dxf, dyf, ixc, ixf, iyc, iyf, shift_m, shift_p
from . import call, check_operands, count, data_ptr, on_cuda, output, placed

__all__ = ["momentum", "momentum_plain", "launch_plan", "STATIC_PLANES",
           "LAYERED_PLANES", "LAP_PLANES", "DRAG_PLANES", "REACH"]

STATIC_PLANES = ("dy_cf", "dx_fc", "inv_az_ff", "f_ff", "dx_cf", "inv_dx_fc", "dy_fc",
                 "inv_dy_cf", "mask_u", "mask_v")
LAYERED_PLANES = STATIC_PLANES[:8]
# ν_h·(Δy/Δx)_cc·m_c, ν_h·(Δx/Δy)_ff·m_ff_u, m_u/Az_fc, ν_h·(Δy/Δx)_ff·m_ff_v,
# ν_h·(Δx/Δy)_cc·m_c, m_v/Az_cf; then Cd·m/h (one layer) or Cd/dz_k·bottom (a stack)
LAP_PLANES = ("lu_c", "lu_f", "lu_s", "lv_f", "lv_c", "lv_s")
DRAG_PLANES = ("dr_u", "dr_v")
REACH = 3  # the kernel writes 0 within this many cells of the edge (its stencil's reach)

# The output tile of one CTA of csrc/momentum.cu for each dtype, (rows, columns); the
# source holds the same numbers and refuses a plan made for others.
TILE = {torch.float32: (8, 64), torch.float64: (8, 32)}
THREADS = 256

_X, _Y = -1, -2


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``momentum`` runs on the card: one launch over the (rows, columns) ``grid``
    of ``tile``s; a CTA of ``threads`` threads loads the ``window`` (its tile and a
    ring of ``REACH`` cells, zero outside the array) of the 8 metric planes once, then
    for each layer u and v over the window, q = ζ + f over the window less its first
    row and column and KE over the tile and a ring of one cell, in ``smem_bytes`` of
    shared memory."""

    tile: tuple
    window: tuple
    grid: tuple
    threads: int
    smem_bytes: int


def _plan(Yb, Xb, tile, itemsize):
    TY, TX = tile
    WY, WX = TY + 2 * REACH, TX + 2 * REACH
    # 8 metric planes, u and v over the window; q over (TY + 5) x (TX + 5); KE over
    # (TY + 1) x (TX + 1)
    smem = (10 * WY * WX + (TY + 5) * (TX + 5) + (TY + 1) * (TX + 1)) * itemsize
    return LaunchPlan(tile=(TY, TX), window=(WY, WX), grid=(-(-Yb // TY), -(-Xb // TX)),
                      threads=THREADS, smem_bytes=smem)


@functools.lru_cache(maxsize=64)
def launch_plan(Yb, Xb, dtype):
    """The launch plan for (Yb, Xb) planes of ``dtype``."""
    return _plan(Yb, Xb, TILE[dtype], torch.empty((), dtype=dtype).element_size())


def _lay_planes(lay, u, n_lay):
    """The closure pack as a list of n_lay planes broadcasting against ``u`` (one
    plane per layer, or per layer of a period, each)."""
    if u.dim() == 2:
        return list(lay)
    return list(lay.reshape((u.shape[-3], n_lay) + lay.shape[-2:]).transpose(0, 1))


def momentum_plain(u, v, static, has_mask=True, lay=None, has_lap=False, has_drag=False,
                   acc=None, mask_out=None, period=None):
    """(Gu, Gv) of halo-filled (Yb, Xb) velocities or (Nz, Yb, Xb) stacks, in the
    TPU kernel's order (``pallas_mom.py:235-268``): the advective terms, masked by the
    last two planes of ``static`` with ``has_mask``; the ν_h Laplacians and the
    quadratic drag from ``lay`` when asked; + ``acc``; × ``mask_out``. With a
    ``period`` below the layer count the layers run as (Nz / period, period) groups
    over which ``lay`` and ``mask_out`` broadcast."""
    if u.dim() == 3 and period is not None and period != u.shape[0]:
        shape = u.shape
        grouped = (-1, period) + tuple(shape[-2:])
        u, v = u.reshape(grouped), v.reshape(grouped)
        if acc is not None:
            acc = tuple(a.reshape(grouped) for a in acc)
        Gu, Gv = momentum_plain(u, v, static, has_mask, lay, has_lap, has_drag, acc,
                                mask_out)
        return Gu.reshape(shape), Gv.reshape(shape)
    dy_cf, dx_fc, inv_az_ff, f_ff, dx_cf, inv_dx_fc, dy_fc, inv_dy_cf = static[:8]
    zeta = (dxf(dy_cf * v) - dyf(dx_fc * u)) * inv_az_ff
    q = zeta + f_ff
    # u-equation (FC): + q̃ v̂ − δxᶠ(K)/Δxᶠᶜ
    v_hat = ixf(iyc(dx_cf * v)) * inv_dx_fc
    q_at_u = weno5_upwind_centers_from_faces(q, v_hat, axis=-2)
    uu = u * u
    vv = v * v
    ke = 0.5 * (ixc(uu) + iyc(vv))
    Gu = q_at_u * v_hat - dxf(ke) * inv_dx_fc
    # v-equation (CF): − q̃ û − δyᶠ(K)/Δyᶜᶠ
    u_hat = iyf(ixc(dy_fc * u)) * inv_dy_cf
    q_at_v = weno5_upwind_centers_from_faces(q, u_hat, axis=-1)
    Gv = -q_at_v * u_hat - dyf(ke) * inv_dy_cf
    if has_mask:
        Gu = Gu * static[8]
        Gv = Gv * static[9]
    n_lay = 6 * has_lap + 2 * has_drag
    planes = _lay_planes(lay, u, n_lay) if n_lay else []
    if has_lap:
        lu_c, lu_f, lu_s, lv_f, lv_c, lv_s = planes[:6]
        gxu = (shift_p(u, _X) - u) * lu_c
        gyu = (u - shift_m(u, _Y)) * lu_f
        Gu = Gu + ((gxu - shift_m(gxu, _X)) + (shift_p(gyu, _Y) - gyu)) * lu_s
        gxv = (v - shift_m(v, _X)) * lv_f
        gyv = (shift_p(v, _Y) - v) * lv_c
        Gv = Gv + ((shift_p(gxv, _X) - gxv) + (gyv - shift_m(gyv, _Y))) * lv_s
    if has_drag:
        dr_u, dr_v = planes[-2:]
        sp_u = torch.sqrt(uu + ixf(iyc(v)) ** 2)
        sp_v = torch.sqrt(vv + iyf(ixc(u)) ** 2)
        Gu = Gu - dr_u * sp_u * u
        Gv = Gv - dr_v * sp_v * v
    if acc is not None:
        Gu = Gu + acc[0]
        Gv = Gv + acc[1]
    if mask_out is not None:
        Gu = Gu * mask_out[0]
        Gv = Gv * mask_out[1]
    return Gu, Gv


def _pair(name, pair):
    """The two tensors of an ``acc``/``mask_out`` operand, or () when it is None."""
    if pair is None:
        return ()
    if not isinstance(pair, (tuple, list)) or len(pair) != 2:
        raise ValueError(f"momentum: {name} is a pair of tensors shaped like u")
    return tuple(pair)


def momentum(u, v, static, has_mask=True, lay=None, has_lap=False, has_drag=False,
             acc=None, mask_out=None, period=None, out=None):
    """(Gu, Gv) of halo-filled (Yb, Xb) velocities or (Nz, Yb, Xb) stacks: masked,
    with the 10-plane ``static``, when ``has_mask``; unmasked, with the 8-plane
    ``static``, when not; plus the fused ν_h Laplacians and quadratic drag of the
    (period·L, Yb, Xb) pack ``lay`` with ``has_lap``/``has_drag``; plus the pair
    ``acc``; times the pair ``mask_out`` ((period, Yb, Xb) each); ``period``
    (default Nz) divides the layer count. Only cells at least ``REACH`` from the
    array edge are meaningful (the kernel writes 0 there). The launch counts as
    ``momentum_members`` for the layers of several layered members (no ``has_mask``,
    a period below the layer count), else as ``momentum_closures`` with a closure
    pack, else as ``momentum`` with the masks and as ``momentum_layered`` without.
    ``out``, a pair shaped like (u, v), receives (Gu, Gv) in place of new tensors."""
    if u.dim() not in (2, 3):
        raise ValueError(f"momentum takes a (Yb, Xb) plane or an (Nz, Yb, Xb) stack, "
                         f"got shape {tuple(u.shape)}")
    Yb, Xb = u.shape[-2:]
    nz = u.shape[0] if u.dim() == 3 else 1
    period = nz if period is None else int(period)
    if period < 1 or nz % period:
        raise ValueError(f"momentum: the period {period} does not divide the {nz} layers")
    per_layer = (period, Yb, Xb) if u.dim() == 3 else (Yb, Xb)
    n_static = len(STATIC_PLANES if has_mask else LAYERED_PLANES)
    n_lay = 6 * bool(has_lap) + 2 * bool(has_drag)
    if (lay is None) != (n_lay == 0):
        raise ValueError("momentum: a closure pack goes with has_lap or has_drag, and "
                         "only with them")
    acc_uv, out_uv = _pair("acc", acc), _pair("mask_out", mask_out)
    tensors = dict(u=u, v=v, static=static)
    shapes = dict(v=u.shape, static=(n_static, Yb, Xb))
    if n_lay:
        tensors["lay"] = lay
        shapes["lay"] = (period * n_lay, Yb, Xb)
    for key, pair, shape in (("acc", acc_uv, u.shape), ("mask_out", out_uv, per_layer)):
        for comp, t in zip("uv", pair):
            tensors[f"{key}_{comp}"] = t
            shapes[f"{key}_{comp}"] = shape
    check_operands("momentum", tensors, u.dtype, shapes)
    out_u, out_v = _pair("out", out) or (None, None)
    if not on_cuda(*tensors.values()):
        Gu, Gv = momentum_plain(u, v, static, has_mask, lay, has_lap, has_drag, acc,
                                mask_out, period)
        return placed("momentum", Gu, out_u), placed("momentum", Gv, out_v)
    plan = launch_plan(Yb, Xb, u.dtype)
    Gu = output("momentum", u, out_u)
    Gv = output("momentum", v, out_v)
    a_u, a_v = acc_uv or (None, None)
    m_u, m_v = out_uv or (None, None)
    call("osg_momentum", u.dtype, u.device, u.data_ptr(), v.data_ptr(),
         static.data_ptr(), *map(data_ptr, (lay, a_u, a_v, m_u, m_v)),
         Gu.data_ptr(), Gv.data_ptr(), nz, Yb, Xb, period, int(has_mask),
         int(bool(has_lap)), int(bool(has_drag)), plan.tile[0], plan.tile[1])
    count("momentum_members" if not has_mask and period < nz else
          "momentum_closures" if n_lay else
          "momentum" if has_mask else "momentum_layered")
    return Gu, Gv
