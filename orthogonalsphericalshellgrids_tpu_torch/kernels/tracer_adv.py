"""Flux-form WENO-5 tracer advection: ``csrc/tracer_adv.cu`` and its plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:tracer_adv_pallas``
with and without the fused κ_h Laplacian, in its two modes:

- column (the single-layer model): ``static`` is the (5, Yb, Xb) stack
  ``STATIC_PLANES`` on the base grid, ``inv_vol_c = mask_c / (Az_cc h_c)``, or the
  (8, Yb, Xb) stack with ``KAPPA_PLANES`` appended (the JAX pack's S = 3 and 6: the
  port keeps h and the metric of each flux as separate planes); the plain version is
  ``models/hydrostatic.py:698-702``;
- layered (``g_pack`` and ``dz`` given): ``c`` is the (n_tr·Nz, Yb, Xb) tracer-major
  stack over (Nz, Yb, Xb) velocities, ``static`` the (Nz·S, Yb, Xb) pack, S = 1
  ([IV = mask_c3 / (Az_cc dz_k)], ``pack_adv_statics_layered``) or S = 4 (IV then
  ``KAPPA_PLANES`` of the layer), ``g_pack`` the (2, Yb, Xb) planes [dy_fc, dx_cf]
  and ``dz`` the (Nz,) layer thicknesses on the tensors' device. u and v must be
  masked, so that u·dzu == u·dz_k; the plain version is ``models/layered.py:820-824``.

κ_h adds G += (δx⁺(K_u·δx⁻c) + δy⁺(K_v·δy⁻c))·K_c (``pallas_adv.py:239-243``). A pack
of any other size is refused, never read at another stride. In both modes an
additive stack ``acc``, shaped exactly like ``c``, is added last (``pallas_adv.py:244-246``):
G + acc.

The kernel runs in tiles (``launch_plan``): each CTA owns a tile of output cells and
copies its operands into shared memory ahead of use: c over the tile and the stencil's
``REACH`` and ``acc`` per plane, u and v at the tile's faces, IV and the κ_h planes per
layer, the metric planes once. It reconstructs each face of the tile once and forms
the cells' divergence from the stored fluxes; in layered mode it loops over the
layers, and per layer over the tracer blocks, with the next plane's copies in flight.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..ops.advection import weno5_upwind_faces_from_centers
from ..ops.operators import dxc, dxf, dyc, dyf
from . import LAUNCHES, call, check_operands, data_ptr, on_cuda

__all__ = ["tracer_adv", "tracer_adv_plain", "launch_plan", "STATIC_PLANES",
           "KAPPA_PLANES", "G_PLANES", "REACH"]

STATIC_PLANES = ("h_u", "dy_fc", "h_v", "dx_cf", "inv_vol_c")
# κ_h·(Δy/Δx)_fc·m_u, κ_h·(Δx/Δy)_cf·m_v, m_c/Az_cc
KAPPA_PLANES = ("k_u", "k_v", "k_c")
G_PLANES = ("dy_fc", "dx_cf")
REACH = 3  # the kernel writes 0 within this many cells of the edge (its stencil's reach)

# The output tile of one CTA of csrc/tracer_adv.cu for each dtype, (rows, columns); the
# source holds the same numbers and refuses a plan made for others.
TILE = {torch.float32: (16, 32), torch.float64: (16, 32)}
THREADS = 256


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``tracer_adv`` runs on the card: one launch over the (rows, columns)
    ``grid`` of ``tile``s; a CTA of ``threads`` threads copies c over its ``window``
    (the tile and a ring of ``REACH`` cells, zero outside the array) and its other
    operands into shared memory, reconstructs the tile's x faces (rows of columns + 1)
    and y faces (rows + 1 of columns) once and forms each cell from them.
    ``smem_bytes[layered, kappa, acc]`` is its shared memory in each mode (layered
    mode keeps two buffers of what a plane and a layer copy)."""

    tile: tuple
    window: tuple
    grid: tuple
    threads: int
    smem_bytes: dict


def _smem(tile, itemsize, layered, kappa, acc):
    """Bytes of shared memory of one CTA: ``csrc/tracer_adv.cu:Layout``."""
    TY, TX = tile
    window = (TY + 2 * REACH) * (TX + 2 * REACH)
    faces, cells, nb = TY * (TX + 1) + (TY + 1) * TX, TY * TX, 2 if layered else 1
    # windows, fluxes, velocities, lengths (+ column thicknesses), IV, κ_h planes, acc
    n = (nb * window + faces + nb * faces + faces + (0 if layered else faces)
         + nb * cells + (nb * (faces + cells) if kappa else 0) + (nb * cells if acc else 0))
    return n * itemsize


def _plan(Yb, Xb, tile, itemsize):
    TY, TX = tile
    modes = [(lay, kap, acc) for lay in (False, True) for kap in (False, True)
             for acc in (False, True)]
    return LaunchPlan(tile=(TY, TX), window=(TY + 2 * REACH, TX + 2 * REACH),
                      grid=(-(-Yb // TY), -(-Xb // TX)), threads=THREADS,
                      smem_bytes={m: _smem(tile, itemsize, *m) for m in modes})


@functools.lru_cache(maxsize=64)
def launch_plan(Yb, Xb, dtype):
    """The launch plan for (Yb, Xb) planes of ``dtype``."""
    return _plan(Yb, Xb, TILE[dtype], torch.empty((), dtype=dtype).element_size())


def _diffusion(c, k_u, k_v, k_c):
    return (dxc(dxf(c) * k_u) + dyc(dyf(c) * k_v)) * k_c


def tracer_adv_plain(c, u, v, static, g_pack=None, dz=None, acc=None):
    """Column mode: G = -(δx(u h_u Δy cx) + δy(v h_v Δx cy)) · mask_c/(Az h_c) of
    halo-filled (Yb, Xb) fields. Layered mode (``g_pack``, ``dz``): G = -(δx(u dz_k
    Δy cx) + δy(v dz_k Δx cy)) · IV for every tracer block of ``c``. Plus the κ_h
    Laplacian when the pack carries its planes, then ``acc``."""
    if g_pack is None:
        h_u, dy_fc, h_v, dx_cf, inv_vol_c = static[:5]
        kappa = static[5:] if static.shape[0] == 8 else None
    else:
        nz = u.shape[0]
        h_u = h_v = dz.reshape(nz, 1, 1)
        dy_fc, dx_cf = g_pack
        S = static.shape[0] // nz
        planes = static.reshape((nz, S) + static.shape[-2:]).transpose(0, 1)
        inv_vol_c = planes[0]
        kappa = planes[1:] if S == 4 else None
        c = c.reshape((-1, nz) + c.shape[-2:])
    cx = weno5_upwind_faces_from_centers(c, u, axis=-1)
    cy = weno5_upwind_faces_from_centers(c, v, axis=-2)
    fx = u * h_u * dy_fc * cx
    fy = v * h_v * dx_cf * cy
    G = -(dxc(fx) + dyc(fy)) * inv_vol_c
    if kappa is not None:
        G = G + _diffusion(c, *kappa)
    if g_pack is not None:
        G = G.reshape((-1,) + G.shape[-2:])
    return G if acc is None else G + acc


def _with_acc(tensors, acc):
    return tensors if acc is None else dict(tensors, acc=acc)


def tracer_adv(c, u, v, static, g_pack=None, dz=None, acc=None):
    """The tracer tendency of halo-filled fields, in column mode or, with ``g_pack``
    and ``dz``, in layered mode (module docstring), with κ_h when the pack carries
    its planes, plus ``acc`` (shaped like ``c``) when given; only cells at least
    ``REACH`` from the array edge are meaningful (the kernel writes 0 there). The
    launch counts as ``tracer_adv_kappa`` with κ_h, else as ``tracer_adv`` or
    ``tracer_adv_layered``."""
    if (g_pack is None) != (dz is None):
        raise ValueError("tracer_adv: layered mode takes both g_pack and dz")
    Yb, Xb = c.shape[-2:]
    if g_pack is None:
        n_st = static.shape[0] if static.dim() == 3 else -1
        if n_st not in (5, 8):
            raise ValueError(f"tracer_adv: the column pack holds 5 planes, or 8 with "
                             f"κ_h, got shape {tuple(static.shape)}")
        tensors = _with_acc(dict(c=c, u=u, v=v, static=static), acc)
        check_operands("tracer_adv", tensors, c.dtype,
                       dict(c=(Yb, Xb), u=(Yb, Xb), v=(Yb, Xb), static=(n_st, Yb, Xb),
                            acc=(Yb, Xb)))
        if not on_cuda(*tensors.values()):
            return tracer_adv_plain(c, u, v, static, acc=acc)
        plan = launch_plan(Yb, Xb, c.dtype)
        G = torch.empty_like(c)
        call("osg_tracer_adv", c.dtype, c.device, c.data_ptr(), u.data_ptr(),
             v.data_ptr(), static.data_ptr(), data_ptr(acc), G.data_ptr(), Yb, Xb,
             int(n_st == 8), *plan.tile)
        LAUNCHES["tracer_adv_kappa" if n_st == 8 else "tracer_adv"] += 1
        return G
    if u.dim() != 3 or c.dim() != 3:
        raise ValueError("tracer_adv: layered mode takes (P, Yb, Xb) tracers over "
                         "(Nz, Yb, Xb) velocities")
    nz = u.shape[0]
    if c.shape[0] % nz:
        raise ValueError(f"tracer_adv: {c.shape[0]} tracer planes over Nz={nz} layers")
    # exactly 1 or 4 planes per layer: any other pack is refused, not misread
    n_st = static.shape[0] if static.dim() == 3 else -1
    if n_st not in (nz, 4 * nz):
        raise ValueError(f"tracer_adv: the layered pack holds Nz = {nz} planes, or "
                         f"4·Nz with κ_h, got shape {tuple(static.shape)}")
    tensors = _with_acc(dict(c=c, u=u, v=v, static=static, g_pack=g_pack, dz=dz), acc)
    check_operands("tracer_adv", tensors, c.dtype,
                   dict(u=(nz, Yb, Xb), v=(nz, Yb, Xb), static=(n_st, Yb, Xb),
                        g_pack=(len(G_PLANES), Yb, Xb), dz=(nz,), acc=c.shape))
    if not on_cuda(*tensors.values()):
        return tracer_adv_plain(c, u, v, static, g_pack, dz, acc)
    has_diff = n_st == 4 * nz
    plan = launch_plan(Yb, Xb, c.dtype)
    G = torch.empty_like(c)
    call("osg_tracer_adv_layered", c.dtype, c.device, c.data_ptr(), u.data_ptr(),
         v.data_ptr(), static.data_ptr(), g_pack.data_ptr(), dz.data_ptr(), data_ptr(acc),
         G.data_ptr(), c.shape[0], nz, Yb, Xb, int(has_diff), *plan.tile)
    LAUNCHES["tracer_adv_kappa" if has_diff else "tracer_adv_layered"] += 1
    return G
