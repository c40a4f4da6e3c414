"""Multi-layer (Nz > 1) hydrostatic free-surface model on a tripolar grid.

Counterpart: ``orthogonalsphericalshellgrids_tpu/models/layered.py``
(``LayeredState``, ``LayeredModel``, ``make_layered_model``,
``layered_initial_state``, the vertical operators, ``layered_tendencies``,
``layered_step``, ``layered_multi_step``, ``layered_cfl_dt``) on its kernel path:

- per-layer vector-invariant momentum with WENO-5 upwinded vorticity and flux-form
  WENO-5 tracer advection (the single-layer stencils over a leading layer axis),
- every layer-coupled term in one column pass (``kernels/vertical.py``): w from
  continuity, its advection of u and v, the Centered vertical tracer flux, the
  explicit ν_v and κ_v Laplacians, and the hydrostatic pressure gradient of a
  prognostic buoyancy tracer ``b`` or of the linear equation of state in T and S,
- optionally a backward-Euler vertical solve of ν_v and κ_v (``_implicit_vertical_solve``),
- the closures ν_h (fused into the momentum kernel) and κ_h (fused into the tracer
  kernel) with per-layer masks, ν4_h and κ4_h (biharmonic, plain PyTorch), wind
  stress on the surface layer, linear or quadratic bottom drag on the deepest wet
  layer (quadratic fused into the momentum kernel) and user forcing per layer,
- the single-layer model's split-explicit barotropic engine, driven by the
  thickness-weighted baroclinic forcing, then the AB2 predictor, the corrector that
  replaces each column's depth-mean velocity by the subcycle average, and the
  tracer update, in one kernel (``kernels/corrector.py``) unless the vertical solve
  is implicit,
- grid-fitted 3-D masks from the same bottom (a layer cell is fluid when its centre
  lies above the bottom).

Layout: layer axis leading, ``(Nz, Yb, Xb)`` with k = 0 the surface layer; several
tracers stack tracer-major as ``(n·Nz, Yb, Xb)``. The model is an ``nn.Module``
that holds the port's ``HydrostaticModel`` as ``baro``; its arrays are registered
buffers and the state is a frozen dataclass of tensors. ``layered_step`` never
mutates the incoming state and makes no host sync.

Not ported yet: the sharded step and its overlap split (ROADMAP queue 1 item 8).
The JAX package's ``fill_mode``, ``use_pallas`` and ``block_rows`` are TPU choices
with no counterpart; its ``OSG_CORR_KERNEL`` and ``OSG_ACC_FOLD`` switches have none
either: on a card the corrector kernel always runs, and the vertical kernel's
(dGu, dGv, dGc) and the closing mask ride in the momentum and tracer kernels
(their ``acc`` and ``mask_out`` operands) wherever ``fold_mask_out`` and
``fold_tracer_acc`` allow, on every device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ..grids.tripolar import TripolarGrid
from ..kernels import corrector, halo_fill, momentum, tracer_adv, vertical
from ..ops.closures import _ratio, biharmonic_c, biharmonic_u, biharmonic_v
from ..ops.location import CC, CF, FC
from ..ops.operators import dxc, dyc
from .hydrostatic import (ForcingFields, HydrostaticModel, _fill, _inv,
                          barotropic_substeps, crop_ext, embed_ext, from_jax_arrays,
                          make_model)
from .split_explicit import SplitExplicitFreeSurface

__all__ = ["LayeredState", "LayeredModel", "make_layered_model", "layered_from_jax_arrays",
           "layered_initial_state", "layered_state_from_numpy", "vertical_velocity",
           "layered_tendencies", "layered_step", "layered_multi_step", "layered_cfl_dt"]


@dataclasses.dataclass(frozen=True)
class LayeredState:
    """Prognostics: u/v/c/b are (Nz, Yb, Xb) layer stacks (c is (n·Nz, Yb, Xb) with
    several tracers) with their previous tendencies; η/U/V live on the widened
    free-surface grid as in the single-layer model; ``t`` and ``iteration`` are 0-d
    tensors."""

    u: Any
    v: Any
    eta: Any
    U: Any
    V: Any
    c: Any
    b: Any
    Gu: Any
    Gv: Any
    Gc: Any
    Gb: Any
    t: Any
    iteration: Any


# the layered arrays besides ``baro`` (the JAX model's data fields, less the closure
# pack ``mom_lay``, which is None without ν_h and quadratic drag), and its static
# metadata
BUFFERS = ("mask_c3", "mask_u3", "mask_v3", "dzu", "dzv", "inv_h_u", "inv_h_v", "bot_u",
           "bot_v", "adv_pack", "mom_static", "vert_pack", "vert_g")
META = ("nz", "dz", "dzc", "zc", "forcing", "buoyancy", "kappa_v", "nu_v", "vert_impl",
        "tracer_names", "g_b", "alpha_T", "beta_S", "T0", "S0")


class LayeredModel(nn.Module):
    """The layered configuration: ``baro`` (the single-layer model: grids, metric
    reciprocals, immersed boundary, barotropic engine) plus the per-layer masks and
    thicknesses and the kernels' operand packs, as registered buffers:

    - ``mask_c3``/``mask_u3``/``mask_v3``: (Nz, Yb, Xb) fluid masks;
    - ``dzu``/``dzv``: dz·mask, the thicknesses the horizontal fluxes carry;
      ``inv_h_u``/``inv_h_v``: 1 / Σ dzu, 1 / Σ dzv (0 on land);
    - ``bot_u``/``bot_v``: deepest-wet-layer indicators;
    - ``vert_pack`` (Nz·S) and ``vert_g`` (5 planes): the vertical kernel's packs;
      ``mom_static``: the momentum kernel's 8 metric planes; ``mom_lay``: its
      (Nz·L) closure pack (6 ν_h planes, then 2 drag planes, per layer) or None;
      ``adv_pack``: the tracer kernel's (Nz·S) pack, [IV] or [IV, K_u, K_v, K_c]
      per layer with κ_h;
    - ``dz_t``/``dzc_t``/``zc3``: the layer thicknesses, interface spacings and
      (Nz, 1, 1) layer-centre depths, and ``vert_coef``: the vertical kernel's
      (5, Nz) layer coefficients;
    - ``wind_u``/``wind_v``: τ/dz_0 on layer 0, times mask_u3[0]/mask_v3[0] where
      ``fold_mask_out`` holds, or None without wind.

    Static metadata as in the JAX model (``dz``, ``dzc``, ``zc`` are tuples of
    floats, surface first)."""

    def __init__(self, baro: HydrostaticModel, arrays, meta):
        super().__init__()
        self.baro = baro
        for name in BUFFERS:
            self.register_buffer(name, arrays[name])
        self.register_buffer("mom_lay", arrays.get("mom_lay"))
        for name in META:
            setattr(self, name, meta[name])
        dt, dev = baro.dtype, baro.device
        # the surface stress on layer 0, made once; pre-masked where the closing mask
        # rides in the momentum kernel, since it is added after the kernel
        wind_u = wind_v = None
        if baro.wind:
            wind_u, wind_v = baro.taux / self.dz[0], baro.tauy / self.dz[0]
            if self.fold_mask_out:
                wind_u, wind_v = wind_u * self.mask_u3[0], wind_v * self.mask_v3[0]
        self.register_buffer("wind_u", wind_u)
        self.register_buffer("wind_v", wind_v)

        def tensor(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(device=dev, dtype=dt)

        self.register_buffer("dz_t", tensor(self.dz))
        self.register_buffer("dzc_t", tensor(self.dzc))
        self.register_buffer("zc3", tensor(self.zc).view(-1, 1, 1))
        explicit = not self.vert_impl
        self.register_buffer("vert_coef", tensor(vertical.coefficients(
            self.dz, self.dzc, self.nu_v if explicit else 0.0,
            self.kappa_v if explicit else 0.0)))

    @property
    def fold_mask_out(self) -> bool:
        """True when nothing lands on Gu/Gv between the momentum kernel and the
        closing mask but the pre-masked wind (no ν4_h, no linear drag), so that the
        kernel applies the mask (``mask_out``)."""
        return self.baro.nu4_h == 0.0 and self.baro.drag_type != "linear"

    @property
    def fold_tracer_acc(self) -> bool:
        """True when no term lies between the tracer kernel's κ_h and the vertical
        kernel's dGc (no κ4_h), so that the kernel adds dGc (``acc``)."""
        return self.baro.kappa4_h == 0.0

    @property
    def has_b(self) -> bool:
        """True when ``b`` is a prognostic tracer (BuoyancyTracer mode)."""
        return self.buoyancy == "tracer_b"

    @property
    def dz3(self):
        """(Nz, 1, 1) layer thicknesses, broadcastable against field stacks."""
        return self.dz_t.view(-1, 1, 1)

    @property
    def dzc3(self):
        """(Nz-1, 1, 1) centre-to-centre spacings of the interior interfaces."""
        return self.dzc_t.view(-1, 1, 1)

    @property
    def grid(self):
        return self.baro.grid

    @property
    def grid_ext(self):
        return self.baro.grid_ext

    @property
    def dtype(self):
        return self.baro.dtype

    @property
    def device(self):
        return self.baro.device


# --------------------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------------------

def _layer_geometry(grid: TripolarGrid):
    """(zc, dz, dzc) surface-first in float64: layer-centre depths, layer thicknesses
    and interior-interface centre spacings, from the grid's interfaces (stretched
    when ``z_interfaces`` is set, else uniform over ``z_bounds``)."""
    if grid.z_interfaces is not None:
        z_f = np.asarray(grid.z_interfaces, np.float64)
    else:
        z0, z1 = grid.z_bounds
        z_f = np.linspace(z0, z1, grid.Nz + 1)
    zf = z_f[::-1]
    dz = zf[:-1] - zf[1:]
    zc = 0.5 * (zf[:-1] + zf[1:])
    dzc = 0.5 * (dz[:-1] + dz[1:])
    return zc, dz, dzc


def _buoyancy_mode(buoyancy, tracers):
    if isinstance(buoyancy, str):
        if buoyancy == "linear_eos":
            if "T" not in tracers and "S" not in tracers:
                raise ValueError('buoyancy="linear_eos" requires a "T" and/or "S" tracer')
            return "linear_eos"
        if buoyancy == "none":
            return "none"
        raise ValueError(f"unknown buoyancy mode {buoyancy!r}")
    # any truthy non-string (True, np.True_, 1) selects the prognostic tracer
    return "tracer_b" if bool(buoyancy) else "none"


def make_layered_model(
    grid: TripolarGrid,
    free_surface: SplitExplicitFreeSurface | None = None,
    bottom_height=None,
    buoyancy: bool | str = False,
    tracers: tuple = ("c",),
    coriolis: bool = False,
    rotation_rate: float = 7.292115e-5,
    kappa_v: float = 0.0,
    nu_v: float = 0.0,
    vertical_time_discretization: str = "explicit",
    gravitational_acceleration: float = 9.80665,
    thermal_expansion: float = 1.67e-4,
    haline_contraction: float = 7.80e-4,
    reference_temperature: float = 0.0,
    reference_salinity: float = 35.0,
    wind_stress=None,
    bottom_drag=None,
    nu_h: float = 0.0,
    kappa_h: float = 0.0,
    nu4_h: float = 0.0,
    kappa4_h: float = 0.0,
    tracer_advection: str = "weno5",
    momentum_advection: str = "weno_vector_invariant",
    forcing=None,
    *,
    device="cuda",
) -> LayeredModel:
    """Assemble the layered model on ``device`` (where ``grid`` must lie; the card
    unless the caller asks for the CPU). The embedded single-layer model provides
    the barotropic engine and the column immersed boundary; the layers are the
    grid's own z discretization, k = 0 at the surface. ``buoyancy``: False (none), True (prognostic ``b``) or ``"linear_eos"``
    (b = g (α (T − T0) − β (S − S0)) from the ``"T"``/``"S"`` tracers).
    ``wind_stress`` acts on layer 0 and ``bottom_drag`` on the deepest wet layer of
    each column; ``forcing`` is {target: fn}, target "u", "v", "b" (with a
    prognostic b) or a tracer's name, fn(λ°, φ°, z, t, fields) -> the per-layer
    tendency term, on tensors (z the (Nz, 1, 1) layer-centre depths)."""
    tracers = tuple(str(t) for t in tracers)
    if len(tracers) == 0 or len(set(tracers)) != len(tracers):
        raise ValueError(f"tracers must be a non-empty tuple of unique names, got {tracers!r}")
    if vertical_time_discretization not in ("explicit", "implicit"):
        raise ValueError(
            f"vertical_time_discretization must be 'explicit' or 'implicit', "
            f"got {vertical_time_discretization!r}")
    mode = _buoyancy_mode(buoyancy, tracers)
    forcing = dict(forcing or {})
    valid_targets = {"u", "v", *tracers} | ({"b"} if mode == "tracer_b" else set())
    unknown = set(forcing) - valid_targets
    if unknown:
        raise ValueError(f"forcing targets {sorted(unknown)} not in {sorted(valid_targets)}")
    baro = make_model(grid, free_surface=free_surface, bottom_height=bottom_height,
                      coriolis=coriolis, rotation_rate=rotation_rate,
                      tracer_advection=tracer_advection,
                      momentum_advection=momentum_advection, wind_stress=wind_stress,
                      bottom_drag=bottom_drag, nu_h=nu_h, kappa_h=kappa_h, nu4_h=nu4_h,
                      kappa4_h=kappa4_h, device=device)
    nz = grid.Nz
    zc, dz_layers, dzc_layers = _layer_geometry(grid)

    # full-cell GridFittedBottom: a layer cell is fluid iff its centre lies above the
    # bottom and the column itself is fluid
    bot = baro.ib.bottom.cpu().numpy().astype(np.float64)
    col = baro.ib.mask_c.cpu().numpy().astype(np.float64) > 0
    wet = (zc[:, None, None] > bot[None]) & col[None]
    mask_c3 = wet.astype(np.float64)
    mask_u3 = mask_c3 * np.roll(mask_c3, 1, axis=-1)
    mask_v3 = mask_c3 * np.roll(mask_c3, 1, axis=-2)
    dt, dev = grid.dtype, grid.device
    mask_c3, mask_u3, mask_v3 = (torch.as_tensor(m).to(device=dev, dtype=dt)
                                 for m in (mask_c3, mask_u3, mask_v3))

    def bottom_indicator(m3):
        below = torch.cat([m3[1:], torch.zeros_like(m3[:1])], dim=0)
        return m3 * (1.0 - below)

    # the corrector's column depths are the quantized Σ dz·mask, the thickness the
    # layer fluxes carry, not the continuous ib.h_u/h_v
    dz3 = torch.as_tensor(dz_layers).to(device=dev, dtype=dt).reshape(-1, 1, 1)
    dzu = dz3 * mask_u3
    dzv = dz3 * mask_v3
    bot_u3, bot_v3 = bottom_indicator(mask_u3), bottom_indicator(mask_v3)

    # the kernels' per-layer closure planes (layered.py:326-346 and :375-381 of the
    # JAX package), layer-major: plane k·L + i is layer k's i-th factor
    lay_parts = []
    if nu_h > 0.0:
        m_ff_u = mask_u3 * torch.roll(mask_u3, 1, dims=-2)
        m_ff_v = mask_v3 * torch.roll(mask_v3, 1, dims=-1)
        lay_parts += [nu_h * _ratio(grid.dy_cc, grid.dx_cc) * mask_c3,
                      nu_h * _ratio(grid.dx_ff, grid.dy_ff) * m_ff_u,
                      _inv(grid.az_fc) * mask_u3,
                      nu_h * _ratio(grid.dy_ff, grid.dx_ff) * m_ff_v,
                      nu_h * _ratio(grid.dx_cc, grid.dy_cc) * mask_c3,
                      _inv(grid.az_cf) * mask_v3]
    if baro.drag_type == "quadratic":
        cd_dz = torch.full_like(dz3, baro.drag_coeff) / dz3  # a true division, as in JAX
        lay_parts += [cd_dz * bot_u3, cd_dz * bot_v3]
    adv_parts = [mask_c3 * _inv(grid.az_cc * dz3)]
    if kappa_h > 0.0:
        adv_parts += [kappa_h * _ratio(grid.dy_fc, grid.dx_fc) * mask_u3,
                      kappa_h * _ratio(grid.dx_cf, grid.dy_cf) * mask_v3,
                      _inv(grid.az_cc) * mask_c3]

    def layer_major(parts):
        return torch.stack(parts, dim=1).reshape((-1,) + mask_c3.shape[1:])

    vert_impl = vertical_time_discretization == "implicit"
    # the u/v mask planes ride only when the explicit ν_v needs them (S = 3)
    vparts = [mask_c3] + ([mask_u3, mask_v3] if nu_v > 0.0 and not vert_impl else [])
    arrays = dict(
        mask_c3=mask_c3, mask_u3=mask_u3, mask_v3=mask_v3, dzu=dzu, dzv=dzv,
        inv_h_u=_inv(torch.sum(dzu, dim=0)), inv_h_v=_inv(torch.sum(dzv, dim=0)),
        bot_u=bot_u3, bot_v=bot_v3, adv_pack=layer_major(adv_parts),
        mom_lay=layer_major(lay_parts) if lay_parts else None,
        mom_static=torch.stack([grid.dy_cf, grid.dx_fc, baro.inv_az_ff, baro.f_ff,
                                grid.dx_cf, baro.inv_dx_fc, grid.dy_fc, baro.inv_dy_cf]),
        vert_pack=layer_major(vparts),
        vert_g=torch.stack([_inv(grid.az_cc), baro.inv_dx_fc, baro.inv_dy_cf,
                            grid.dy_fc, grid.dx_cf]))
    meta = dict(
        nz=nz, dz=tuple(float(x) for x in dz_layers),
        dzc=tuple(float(x) for x in dzc_layers), zc=tuple(float(x) for x in zc),
        forcing=tuple(forcing.items()), buoyancy=mode, kappa_v=float(kappa_v),
        nu_v=float(nu_v), vert_impl=vert_impl, tracer_names=tracers,
        g_b=float(gravitational_acceleration), alpha_T=float(thermal_expansion),
        beta_S=float(haline_contraction), T0=float(reference_temperature),
        S0=float(reference_salinity))
    return LayeredModel(baro, arrays, meta)


def layered_from_jax_arrays(arrays: dict, meta: dict, device) -> LayeredModel:
    """Build the port's layered model from a JAX package ``LayeredModel``'s leaves.

    ``arrays["baro"]`` and ``meta["baro"]`` are the embedded model's leaves in
    ``from_jax_arrays``'s layout; the other keys of ``arrays`` are the layered data
    fields (``np.asarray`` of each, ``mom_lay`` None without ν_h and quadratic drag),
    and ``meta`` holds the layered metadata fields (forcing functions on tensors).
    Nothing is regenerated, so a step can be compared apart from grid and mask
    generation."""
    baro = from_jax_arrays(arrays["baro"], meta["baro"], device)
    data = {n: torch.from_numpy(np.array(arrays[n])).to(device) for n in BUFFERS}
    if arrays.get("mom_lay") is not None:
        data["mom_lay"] = torch.from_numpy(np.array(arrays["mom_lay"])).to(device)
    return LayeredModel(baro, data, {n: meta[n] for n in META})


def layered_initial_state(model: LayeredModel, u=None, v=None, c=None, b=None,
                          eta=None) -> LayeredState:
    """Initial state from functions of (λ°, φ°, z[m]) sampled per layer at the
    staggered locations (the reference's ``set!`` with a z argument); η from a
    function of (λ°, φ°). With several tracers ``c`` is a dict ``{name: fn}``
    (missing names start at 0) or a sequence of functions in ``tracer_names``
    order. Halos start at 0 and everything is masked."""
    g = model.grid
    dt, dev = model.dtype, model.device
    zc, _, _ = _layer_geometry(g)
    names = model.tracer_names

    def sample(fn, lam, phi):
        out = np.zeros((model.nz,) + g.shape2d)
        if fn is None:
            return out
        lam = lam.cpu().numpy().astype(np.float64)
        phi = phi.cpu().numpy().astype(np.float64)
        for k in range(model.nz):
            full = np.broadcast_to(np.asarray(fn(lam, phi, zc[k])), g.shape2d)
            out[k][g.interior2d] = full[g.interior2d]
        return out

    if len(names) == 1 and not isinstance(c, (dict, list, tuple)):
        c_raw = sample(c, g.lam_cc, g.phi_cc)
    else:
        if c is None:
            fns = [None] * len(names)
        elif isinstance(c, dict):
            unknown = set(c) - set(names)
            if unknown:
                raise ValueError(f"unknown tracer names {sorted(unknown)}; "
                                 f"model tracers are {names}")
            fns = [c.get(nm) for nm in names]
        else:
            if len(c) != len(names):
                raise ValueError(f"got {len(c)} tracer initializers for "
                                 f"{len(names)} tracers {names}")
            fns = list(c)
        c_raw = np.concatenate([sample(fn, g.lam_cc, g.phi_cc) for fn in fns], axis=0)
    u_raw = sample(u, g.lam_fc, g.phi_fc)
    v_raw = sample(v, g.lam_cf, g.phi_cf)
    b_raw = sample(b, g.lam_cc, g.phi_cc)
    eta_raw = np.zeros(g.shape2d)
    if eta is not None:
        full = np.broadcast_to(np.asarray(eta(
            g.lam_cc.cpu().numpy().astype(np.float64),
            g.phi_cc.cpu().numpy().astype(np.float64))), g.shape2d)
        eta_raw[g.interior2d] = full[g.interior2d]

    def t(a):
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    u0 = t(u_raw) * model.mask_u3
    v0 = t(v_raw) * model.mask_v3
    c0 = _mask_tracers(model, t(c_raw))
    b0 = t(b_raw) * model.mask_c3
    eta0 = t(eta_raw) * model.baro.ib.mask_c
    ge = model.grid_ext
    z3 = torch.zeros((model.nz,) + g.shape2d, dtype=dt, device=dev)
    return LayeredState(
        u=u0, v=v0, eta=embed_ext(g, ge, eta0),
        U=embed_ext(g, ge, torch.sum(u0 * model.dzu, dim=0)),
        V=embed_ext(g, ge, torch.sum(v0 * model.dzv, dim=0)), c=c0, b=b0,
        Gu=z3, Gv=z3.clone(), Gc=torch.zeros_like(c0), Gb=z3.clone(),
        t=torch.zeros((), dtype=dt, device=dev),
        iteration=torch.zeros((), dtype=torch.int32, device=dev))


def layered_state_from_numpy(fields: dict, device) -> LayeredState:
    """A ``LayeredState`` from numpy arrays (e.g. ``np.asarray`` of a JAX state's
    fields)."""
    return LayeredState(**{f.name: torch.from_numpy(np.array(fields[f.name])).to(device)
                           for f in dataclasses.fields(LayeredState)})


# --------------------------------------------------------------------------------------
# Vertical operators (layer axis -3, k = 0 surface; no z halos, edges handled inline).
# The step takes all of them but the implicit solve from the vertical kernel; these
# are the JAX package's XLA formulation, an independent statement of the same terms.
# --------------------------------------------------------------------------------------

def vertical_velocity(model: LayeredModel, u, v):
    """w at the layer interfaces (Nz+1, Yb, Xb) from continuity, summed up from the
    sea floor (w = 0 there); interface k is the top of layer k. Inputs halo-filled."""
    g = model.grid
    hdiv = (dxc(g.dy_fc * model.dzu * u) + dyc(g.dx_cf * model.dzv * v)) * _inv(g.az_cc)
    below = torch.flip(torch.cumsum(torch.flip(hdiv, (0,)), dim=0), (0,))
    return torch.cat([-below, torch.zeros_like(hdiv[:1])], dim=0)


def _as_tracer4(model: LayeredModel, c):
    """(n·Nz, Yb, Xb) tracer-major stack -> (n, Nz, Yb, Xb) view."""
    return c.reshape((len(model.tracer_names), model.nz) + c.shape[-2:])


def _as_tracer_stack(model: LayeredModel, c4):
    """Inverse of ``_as_tracer4``: (Nz, ...) for one tracer, (n·Nz, ...) otherwise."""
    return c4.reshape((-1,) + c4.shape[-2:])


def _mask_tracers(model: LayeredModel, c):
    """A tracer stack times mask_c3 (broadcast per tracer)."""
    return _as_tracer_stack(model, _as_tracer4(model, c) * model.mask_c3)


def _zs(q, lo, hi):
    return q[..., lo:hi, :, :] if hi is not None else q[..., lo:, :, :]


def _zcat(parts):
    return torch.cat(parts, dim=-3)


def _w_advect(w_face, q, dzc):
    """Advective-form ``w ∂z q`` at layer points from interface velocities
    ``w_face`` (Nz+1, ...) co-located with q; no flux through surface and floor."""
    dq = (_zs(q, 0, -1) - _zs(q, 1, None)) / dzc
    contrib = _zs(w_face, 1, -1) * dq
    zero = torch.zeros_like(_zs(q, 0, 1))
    return 0.5 * (_zcat([zero, contrib]) + _zcat([contrib, zero]))


def _vertical_tracer_div(w, c, dz):
    """-δz(w c̃)/dz_k with Centered interface values and zero flux through surface
    and floor, so Σ G·dz telescopes to exact conservation."""
    F = _zs(w, 1, -1) * (0.5 * (_zs(c, 0, -1) + _zs(c, 1, None)))
    zero = torch.zeros_like(_zs(c, 0, 1))
    Ffull = _zcat([zero, F, zero])
    return -(_zs(Ffull, 0, -1) - _zs(Ffull, 1, None)) / dz


def _vertical_laplacian(q, dz, dzc, mask):
    """Explicit δz(δz q) with zero-flux boundaries and fluxes only between fluid
    cells: the gradient spans ``dzc``, the divergence ``dz``."""
    dq = (_zs(q, 0, -1) - _zs(q, 1, None)) / dzc * (_zs(mask, 0, -1) * _zs(mask, 1, None))
    zero = torch.zeros_like(_zs(q, 0, 1))
    Ffull = _zcat([zero, dq, zero])
    return (_zs(Ffull, 0, -1) - _zs(Ffull, 1, None)) / dz


def _implicit_vertical_solve(q, r, dz, dzc, mask):
    """Backward-Euler vertical diffusion: x with ``(I - r·Lz) x = q`` along axis -3,
    ``Lz`` the flux-form operator of ``_vertical_laplacian`` and ``r = dt·κ`` [m²] (a
    0-d tensor). A Thomas solve unrolled over the layers, plane by plane; ``dz`` and
    ``dzc`` are the tuples of floats, ``mask`` (Nz, Y, X) broadcasts against a
    leading tracer axis of ``q``. Σ dz·x = Σ dz·q per column."""
    nz = q.shape[-3]
    if nz == 1:
        return q

    def pl(A, k):
        return A[..., k, :, :]

    M = [pl(mask, k - 1) * pl(mask, k) for k in range(1, nz)]
    a = [None] + [-(r / (dz[k] * dzc[k - 1])) * M[k - 1] for k in range(1, nz)]
    c = [-(r / (dz[k] * dzc[k])) * M[k] for k in range(nz - 1)] + [None]
    cp = [None] * nz
    dp = [None] * nz
    b0 = 1.0 - c[0]
    cp[0] = c[0] / b0
    dp[0] = pl(q, 0) / b0
    for k in range(1, nz):
        bk = 1.0 - (a[k] if a[k] is not None else 0.0) - (c[k] if c[k] is not None else 0.0)
        denom = bk - a[k] * cp[k - 1]
        cp[k] = (c[k] / denom) if c[k] is not None else None
        dp[k] = (pl(q, k) - a[k] * dp[k - 1]) / denom
    x = [None] * nz
    x[nz - 1] = dp[nz - 1]
    for k in range(nz - 2, -1, -1):
        x[k] = dp[k] - cp[k] * x[k + 1]
    return torch.stack(x, dim=-3)


def _hydrostatic_pressure(b, dz):
    """Kinematic pressure p_k = -∫_{z_k}^0 b dz' at layer centres (k = 0 surface),
    by one cumulative sum; ``dz`` is the (Nz, 1, 1) thickness."""
    csum = torch.cumsum(b * dz, dim=0)
    return -(csum - 0.5 * dz * b)


def _linear_eos_buoyancy(model: LayeredModel, c):
    """b = g (α (T − T0) − β (S − S0)) · mask_c3 from the tracer stack; a missing T
    or S contributes zero."""
    c4 = _as_tracer4(model, c)
    names = model.tracer_names
    b = torch.zeros_like(c4[0])
    if "T" in names:
        b = b + model.alpha_T * (c4[names.index("T")] - model.T0)
    if "S" in names:
        b = b - model.beta_S * (c4[names.index("S")] - model.S0)
    return model.g_b * b * model.mask_c3


# --------------------------------------------------------------------------------------
# Dynamics
# --------------------------------------------------------------------------------------

def layered_tendencies(model: LayeredModel, u, v, c, b, t=0.0):
    """(Gu, Gv, Gc, Gb) of halo-filled stacks, in the kernel-path assembly of the
    JAX package (``layered.py:670-873`` with the ``acc`` fold on): the vertical
    kernel first, then momentum (advection, ν_h and quadratic drag) plus dGu in the
    kernel, wind on layer 0, linear drag, −ν4_h·∇⁴u, the mask (in the kernel, the
    wind pre-masked, where ``fold_mask_out`` holds); the tracer kernel (advection and
    κ_h) on c and b, −κ4_h·∇⁴c, plus dGc (in the kernel where ``fold_tracer_acc``
    holds); then the user forcing. ``b`` is ignored (and Gb is zeros) without a
    prognostic buoyancy; ``t`` is the model time handed to the forcing functions."""
    g, m = model.grid, model.baro
    names = model.tracer_names
    eos = model.buoyancy == "linear_eos"
    explicit = not model.vert_impl
    dgu, dgv, dgc = vertical.vertical(
        u, v, c, b if model.has_b else None, model.vert_pack, model.vert_g,
        model.vert_coef, mode=model.buoyancy,
        eos=(model.g_b, model.alpha_T, model.beta_S, model.T0, model.S0),
        it_T=names.index("T") if eos and "T" in names else -1,
        it_S=names.index("S") if eos and "S" in names else -1,
        viscous=explicit and model.nu_v > 0.0, diffusive=explicit and model.kappa_v > 0.0)
    fold_mask = model.fold_mask_out
    Gu, Gv = momentum.momentum(u, v, model.mom_static, has_mask=False, lay=model.mom_lay,
                               has_lap=m.nu_h > 0.0, has_drag=m.drag_type == "quadratic",
                               acc=(dgu, dgv),
                               mask_out=(model.mask_u3, model.mask_v3) if fold_mask else None)
    if m.wind:  # surface stress accelerates the top layer (Gu is a fresh tensor)
        Gu[0] += model.wind_u
        Gv[0] += model.wind_v
    if m.drag_type == "linear":
        r_dz = torch.full_like(model.dz3, m.drag_coeff) / model.dz3
        Gu = Gu - r_dz * u * model.bot_u
        Gv = Gv - r_dz * v * model.bot_v
    if m.nu4_h > 0.0:
        Gu = Gu - m.nu4_h * biharmonic_u(g, u, model.mask_u3, model.mask_c3)
        Gv = Gv - m.nu4_h * biharmonic_v(g, v, model.mask_v3, model.mask_c3)
    if not fold_mask:
        Gu = Gu * model.mask_u3
        Gv = Gv * model.mask_v3

    g_pack = model.vert_g[3:5]  # [dy_fc, dx_cf]
    fold_acc = model.fold_tracer_acc

    def tracer_tendency(q, dg):
        if fold_acc:  # no κ4_h: dGc rides in the kernel
            return tracer_adv.tracer_adv(q, u, v, model.adv_pack, g_pack, model.dz_t,
                                         acc=dg)
        G = tracer_adv.tracer_adv(q, u, v, model.adv_pack, g_pack, model.dz_t)
        q4 = q.reshape((-1, model.nz) + q.shape[-2:])
        G = G - m.kappa4_h * biharmonic_c(g, q4, model.mask_c3, model.mask_u3,
                                          model.mask_v3).reshape(q.shape)
        return G + dg

    ncp = c.shape[0]
    Gc = tracer_tendency(c, dgc[:ncp])
    Gb = tracer_tendency(b, dgc[ncp:]) if model.has_b else torch.zeros_like(b)

    if model.forcing:  # pointwise per layer; Gc and Gb are fresh tensors
        fields = ForcingFields(u=u, v=v, c=c, b=b if model.has_b else None)
        z3, nz = model.zc3, model.nz
        for name, fn in model.forcing:
            if name == "u":
                Gu = Gu + fn(g.lam_fc, g.phi_fc, z3, t, fields) * model.mask_u3
            elif name == "v":
                Gv = Gv + fn(g.lam_cf, g.phi_cf, z3, t, fields) * model.mask_v3
            elif name == "b":
                Gb = Gb + fn(g.lam_cc, g.phi_cc, z3, t, fields) * model.mask_c3
            else:
                k = names.index(name)
                Gc[k * nz:(k + 1) * nz] += fn(g.lam_cc, g.phi_cc, z3, t,
                                              fields) * model.mask_c3
    return Gu, Gv, Gc, Gb


def layered_step(model: LayeredModel, state: LayeredState, dt) -> LayeredState:
    """One layered time step: halo fills, tendencies, quasi-AB2, the barotropic
    subcycle driven by the thickness-weighted baroclinic forcing, then the AB2
    predictor, the split-explicit corrector and the tracer update: one corrector
    kernel on a card, or, when the vertical solve is implicit (it sits between the
    predictor and the corrector), the torch chain with the solve, as in the JAX
    package (``layered.py:1128-1176``). ``state`` is not modified."""
    g, ge, m = model.grid, model.grid_ext, model.baro
    # a number becomes a device scalar by a fill launch; copying it from the host
    # would wait for the stream to drain on every step
    dt = (dt.to(device=model.device, dtype=model.dtype) if torch.is_tensor(dt) else
          torch.full((), float(dt), dtype=model.dtype, device=model.device))

    u = _fill(g, state.u, FC, -1)
    v = _fill(g, state.v, CF, -1)
    c = _fill(g, state.c, CC, 1)
    b = _fill(g, state.b, CC, 1) if model.has_b else state.b
    eta_f = _fill(ge, state.eta, CC, 1)
    U_f = _fill(ge, state.U, FC, -1)
    V_f = _fill(ge, state.V, CF, -1)

    Gu, Gv, Gc, Gb = layered_tendencies(model, u, v, c, b, t=state.t)

    first = state.iteration == 0
    w1 = torch.where(first, m.ab2[0], m.ab2[2])
    w2 = torch.where(first, m.ab2[1], m.ab2[3])
    Gu_s = w1 * Gu - w2 * state.Gu
    Gv_s = w1 * Gv - w2 * state.Gv

    # the thickness-weighted depth integral of the baroclinic forcing drives the
    # subcycle, valid through the widened halo after its fill
    GU_f = halo_fill.fill_halos(embed_ext(g, ge, torch.sum(Gu_s * model.dzu, dim=0)), FC,
                                -1, ge.Nx, ge.Ny, ge.Hx, ge.Hy)
    GV_f = halo_fill.fill_halos(embed_ext(g, ge, torch.sum(Gv_s * model.dzv, dim=0)), CF,
                                -1, ge.Nx, ge.Ny, ge.Hx, ge.Hy)
    n_sub = m.weights.shape[0]
    eta_a, U_a, V_a = barotropic_substeps(m, eta_f, U_f, V_f, GU_f, GV_f, dt,
                                          wrap_x_each_substep=ge.Hx < n_sub + 1)

    if model.vert_impl and (model.nu_v > 0.0 or model.kappa_v > 0.0):
        u_new, v_new, c_new, b_new = _implicit_update(model, state, Gu, Gv, Gc, Gb,
                                                      U_a, V_a, w1, w2, dt)
    else:
        u_new, v_new, c_new, b_new = corrector.corrector(
            state.u, Gu, state.Gu, state.v, Gv, state.Gv, state.c, Gc, state.Gc,
            model.dzu, model.dzv, model.mask_c3, model.inv_h_u, model.inv_h_v,
            crop_ext(g, ge, U_a), crop_ext(g, ge, V_a), w1, w2, dt,
            b=(state.b, Gb, state.Gb) if model.has_b else None)
        if not model.has_b:
            b_new = state.b

    return LayeredState(
        u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new, b=b_new, Gu=Gu, Gv=Gv, Gc=Gc,
        Gb=Gb if model.has_b else state.Gb, t=state.t + dt,
        iteration=state.iteration + 1)


def _implicit_update(model: LayeredModel, state: LayeredState, Gu, Gv, Gc, Gb, U_a, V_a,
                     w1, w2, dt):
    """The corrector's plain pieces with the backward-Euler vertical solves between
    them (``layered.py:1153-1176`` of the JAX package): (u, v, c, b)."""
    g, ge = model.grid, model.grid_ext
    u_star, v_star = corrector.predictor_plain(state.u, Gu, state.Gu, state.v, Gv,
                                               state.Gv, model.dzu, model.dzv, w1, w2, dt)
    if model.nu_v > 0.0:
        # Σ dz·u is conserved by the solve, so the depth-mean replacement holds
        r = dt * model.nu_v
        u_star = _implicit_vertical_solve(u_star, r, model.dz, model.dzc, model.mask_u3)
        v_star = _implicit_vertical_solve(v_star, r, model.dz, model.dzc, model.mask_v3)
    u_new, v_new = corrector.depth_mean_plain(
        u_star, v_star, model.dzu, model.dzv, model.inv_h_u, model.inv_h_v,
        crop_ext(g, ge, U_a), crop_ext(g, ge, V_a))
    c_new, b_new = corrector.tracer_update_plain(
        state.c, Gc, state.Gc, model.mask_c3, w1, w2, dt,
        b=(state.b, Gb, state.Gb) if model.has_b else None)
    if model.kappa_v > 0.0:
        r = dt * model.kappa_v
        c_new = _as_tracer_stack(model, _implicit_vertical_solve(
            _as_tracer4(model, c_new), r, model.dz, model.dzc, model.mask_c3))
        if model.has_b:
            b_new = _implicit_vertical_solve(b_new, r, model.dz, model.dzc, model.mask_c3)
    return u_new, v_new, c_new, state.b if b_new is None else b_new


def layered_multi_step(model: LayeredModel, state: LayeredState, dt,
                       n_steps: int) -> LayeredState:
    """``n_steps`` layered steps at a fixed ``dt``."""
    for _ in range(n_steps):
        state = layered_step(model, state, dt)
    return state


def layered_cfl_dt(model: LayeredModel, state: LayeredState, cfl=0.3):
    """Advective-CFL time step over all layers, as a 0-d tensor on the model's
    device."""
    m = model.baro
    speed = torch.abs(state.u) * m.inv_dx_fc + torch.abs(state.v) * m.inv_dy_cf
    smax = torch.max(model.grid.interior(speed))
    return torch.where(smax > 0, cfl / smax, torch.full_like(smax, float("inf")))
