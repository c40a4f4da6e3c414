"""Hydrostatic free-surface model on a tripolar grid (single-layer configuration).

Counterpart: ``orthogonalsphericalshellgrids_tpu/models/hydrostatic.py`` (``make_model``,
``initial_state``, ``vorticity``, ``ForcingFields``, ``tendencies``,
``embed_ext``/``crop_ext``, ``barotropic_substeps``, ``step``, ``multi_step``,
``compute_cfl_dt``) on its kernel path (``tend_kernels``):

- vector-invariant momentum with upwinded WENO-5 vorticity reconstruction,
- flux-form WENO-5 tracer advection of one tracer,
- split-explicit free surface with SM05-averaged forward-backward substeps integrated
  in widened halos, so the substep loop needs no exchange,
- quasi-Adams-Bashforth-2 time stepping (χ = 0.1, forward Euler on the first step),
- grid-fitted immersed-boundary masking, optional Coriolis,
- the closures ν_h, κ_h (fused into the momentum and tracer kernels as prefactored
  planes), ν4_h, κ4_h (biharmonic, plain PyTorch), kinematic wind stress, linear or
  quadratic bottom drag (quadratic fused into the momentum kernel) and user forcing.

The model is an ``nn.Module`` whose arrays are registered buffers (metric reciprocals,
masks, column depths and the kernels' operand stacks, on the base and the extended
free-surface grid); the state is a frozen dataclass of tensors; the dynamics are
plain functions. The four hot operations go through ``kernels/``: on a CUDA device
they launch the hand-written kernels, on the CPU they run the plain PyTorch
versions. ``step`` never mutates the incoming state: the prognostic fields are
filled out of place, into fresh buffers, and only the forcing planes the step makes
itself are filled in place.

Not ported yet (``make_model`` raises ``NotImplementedError``; ROADMAP queue 1):
several tracers and the other advection schemes.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..grids.immersed import FIELDS as IB_FIELDS
from ..grids.immersed import ImmersedBoundary, make_immersed_boundary
from ..grids.tripolar import ARRAY_FIELDS, META_FIELDS, TripolarGrid, with_halo
from ..kernels import barotropic, halo_fill, momentum, tracer_adv
from ..ops.closures import _ratio, biharmonic_c, biharmonic_u, biharmonic_v
from ..ops.location import CC, CF, FC
from ..ops.operators import dxf, dyf
from .split_explicit import SplitExplicitFreeSurface

__all__ = ["HydrostaticModel", "State", "ForcingFields", "make_model", "from_jax_arrays",
           "initial_state", "state_from_numpy", "vorticity", "tendencies", "embed_ext",
           "crop_ext", "barotropic_substeps", "step", "multi_step", "compute_cfl_dt"]

_CHI = 0.1  # quasi-AB2 parameter (Oceananigans default)


@dataclasses.dataclass(frozen=True)
class State:
    """Prognostic state: u/v/c and the previous tendencies on base-halo arrays;
    η/U/V on extended-halo arrays; ``t`` and ``iteration`` are 0-d tensors."""

    u: Any
    v: Any
    eta: Any
    U: Any
    V: Any
    c: Any
    Gu: Any
    Gv: Any
    Gc: Any
    t: Any
    iteration: Any


def _inv(m):
    return torch.where(m > 0, 1.0 / torch.where(m > 0, m, torch.ones_like(m)),
                       torch.zeros_like(m))


# derived arrays a model is assembled from (make_model computes them, from_jax_arrays
# takes the JAX model's); taux/tauy are the masked kinematic wind stress at the u/v
# points (zeros without wind)
DERIVED = ("inv_dx_fc", "inv_dy_cf", "inv_az_ff", "inv_vol_c", "inv_dx_fc_e",
           "inv_dy_cf_e", "inv_az_cc_e", "dy_fc_e", "dx_cf_e", "h_u_e", "h_v_e",
           "mask_u_e", "mask_v_e", "weights", "f_ff", "taux", "tauy")
# the closure, wind, drag and forcing metadata (the JAX model's fields of those names)
OPTIONS = ("forcing", "wind", "drag_type", "drag_coeff", "nu_h", "kappa_h", "nu4_h",
           "kappa4_h")


class HydrostaticModel(nn.Module):
    """Model configuration and precomputed arrays (registered buffers).

    ``grid``/``grid_ext`` are the base and extended-halo grids, ``ib`` the immersed
    boundary on the base grid. ``mom_pack``, ``adv_pack`` and ``baro_pack`` are the
    contiguous operand stacks of the momentum, tracer and barotropic kernels (plane
    order in ``kernels/*.STATIC_PLANES``; ``adv_pack`` ends with the κ_h planes
    ``kernels/tracer_adv.KAPPA_PLANES`` when κ_h > 0). ``mom_lay`` is the momentum
    kernel's closure pack (``kernels/momentum.LAP_PLANES`` with ν_h, then
    ``DRAG_PLANES`` with quadratic drag), None without either. ``options`` holds the
    ``OPTIONS`` metadata; ``kappa`` the three κ_h planes (None without κ_h)."""

    def __init__(self, grid, grid_ext, ib, arrays, *, substeps, fractional_dt, g,
                 coriolis, options, mom_lay=None, kappa=None):
        super().__init__()
        self.grid = grid
        self.grid_ext = grid_ext
        self.ib = ib
        for name in DERIVED:
            self.register_buffer(name, arrays[name])
        self.substeps = int(substeps)
        self.fractional_dt = float(fractional_dt)
        self.g = float(g)
        self.coriolis = bool(coriolis)
        for name, value in options.items():
            setattr(self, name, value)
        self.register_buffer("mom_lay", mom_lay)
        dt = grid.dtype
        self.register_buffer("inv_h_u", _inv(ib.h_u))
        self.register_buffer("inv_h_v", _inv(ib.h_v))
        # AB2 weights: (w1, w2) on the first step, then (1.5 + χ, 0.5 + χ)
        self.register_buffer("ab2", torch.tensor([1.0, 0.0, 1.5 + _CHI, 0.5 + _CHI],
                                                 dtype=dt, device=grid.device))
        planes = dict(
            dy_cf=grid.dy_cf, dx_fc=grid.dx_fc, inv_az_ff=self.inv_az_ff, f_ff=self.f_ff,
            dx_cf=grid.dx_cf, inv_dx_fc=self.inv_dx_fc, dy_fc=grid.dy_fc,
            inv_dy_cf=self.inv_dy_cf, mask_u=ib.mask_u, mask_v=ib.mask_v, h_u=ib.h_u,
            h_v=ib.h_v, inv_vol_c=self.inv_vol_c)
        self.register_buffer("mom_pack", torch.stack(
            [planes[n] for n in momentum.STATIC_PLANES]))
        self.register_buffer("adv_pack", torch.stack(
            [planes[n] for n in tracer_adv.STATIC_PLANES] + list(kappa or ())))
        ext = dict(dy_fc=self.dy_fc_e, dx_cf=self.dx_cf_e, inv_az_cc=self.inv_az_cc_e,
                   gh_u=self.g * self.h_u_e, gh_v=self.g * self.h_v_e,
                   inv_dx_fc=self.inv_dx_fc_e, inv_dy_cf=self.inv_dy_cf_e,
                   mask_u=self.mask_u_e, mask_v=self.mask_v_e)
        self.register_buffer("baro_pack", torch.stack(
            [ext[n] for n in barotropic.STATIC_PLANES]))

    @property
    def dtype(self):
        return self.grid.dtype

    @property
    def device(self):
        return self.grid.device


def _check_supported(tracer_advection, momentum_advection, tracers):
    unsupported = []
    if tracer_advection != "weno5":
        unsupported.append(f"tracer_advection={tracer_advection!r}")
    if momentum_advection != "weno_vector_invariant":
        unsupported.append(f"momentum_advection={momentum_advection!r}")
    if len(tuple(tracers)) != 1:
        unsupported.append(f"tracers={tuple(tracers)!r} (several tracers)")
    if unsupported:
        raise NotImplementedError(
            f"not ported yet: {', '.join(unsupported)} (ROADMAP queue 1, deferred "
            "slice options); the port's single-layer model takes one tracer with "
            "WENO-5 and the WENO vector-invariant momentum")


def make_model(
    grid: TripolarGrid,
    free_surface: SplitExplicitFreeSurface | None = None,
    bottom_height=None,
    coriolis: bool = False,
    rotation_rate: float = 7.292115e-5,
    tracer_advection: str = "weno5",
    momentum_advection: str = "weno_vector_invariant",
    tracers: tuple = ("c",),
    forcing=None,
    wind_stress=None,
    bottom_drag=None,
    nu_h: float = 0.0,
    kappa_h: float = 0.0,
    nu4_h: float = 0.0,
    kappa4_h: float = 0.0,
    *,
    device,
) -> HydrostaticModel:
    """Assemble the model on ``device`` (where ``grid`` must lie): widen the
    free-surface grid's halos to ``len(weights) + 1`` (``with_halo``,
    test/runtests.jl:58-71), precompute reciprocal metrics, masks and column depths
    on both grids, and the kernels' closure planes. A tripolar model requires an
    explicit free surface, as in the reference.

    ``forcing``: {target: fn}, target "u", "v" or the tracer's name, fn(λ°, φ°, t,
    fields) -> the tendency term, on tensors (``fields`` a ``ForcingFields`` of the
    halo-filled prognostics). ``wind_stress``: fn(λ°, φ°) -> (τx, τy), kinematic
    [m²/s²], on numpy arrays. ``bottom_drag``: ("linear", r [m/s]) or ("quadratic",
    Cd). ν_h, κ_h [m²/s] and ν4_h, κ4_h [m⁴/s]: the horizontal closures."""
    if free_surface is None:
        raise ValueError(
            "A tripolar-grid model requires an explicit SplitExplicitFreeSurface "
            "configuration (the reference rejects the default free surface too).")
    _check_supported(tracer_advection, momentum_advection, tracers)
    forcing = dict(forcing or {})
    unknown = set(forcing) - {"u", "v", *(str(t) for t in tracers)}
    if unknown:
        raise ValueError(f"forcing targets {sorted(unknown)} not in "
                         f"{sorted({'u', 'v', *map(str, tracers)})}")
    drag_type, drag_coeff = ("none", 0.0) if bottom_drag is None else bottom_drag
    if drag_type not in ("none", "linear", "quadratic"):
        raise ValueError(f"bottom_drag type must be linear|quadratic, got {drag_type!r}")
    dev = torch.device(device)
    if dev.type != grid.device.type or dev.index not in (None, grid.device.index):
        raise ValueError(f"make_model(device={device!r}) but the grid lies on "
                         f"{grid.device}")
    if min(grid.Hx, grid.Hy) < 3:
        raise ValueError(
            f"tracer_advection='weno5' consumes 3 halo cells per side but the grid halo "
            f"is ({grid.Hx}, {grid.Hy}) — rebuild the grid with halo >= 3")
    # (the biharmonic closures consume 2 halo cells, within WENO-5's 3)
    hx_ext = max(free_surface.required_y_halo, grid.Hx)
    hy_ext = max(free_surface.required_y_halo, grid.Hy)
    grid_ext = with_halo(grid, (hx_ext, hy_ext, grid.Hz))

    if bottom_height is None:
        def bottom_height(lam, phi):  # all ocean
            return np.full_like(lam, grid.z_bounds[0] - 1.0)
    ib = make_immersed_boundary(grid, bottom_height)
    ib_e = make_immersed_boundary(grid_ext, bottom_height)

    # unmasked pole singularities make the barotropic substeps CFL-unstable
    dx_i = grid.interior(grid.dx_cc).cpu().numpy().astype(np.float64)
    wet = grid.interior(ib.mask_c).cpu().numpy() > 0
    if wet.any():
        dx_wet = dx_i[wet]
        if dx_wet.min() < 1e-3 * np.median(dx_wet):
            warnings.warn(
                "Tripolar pole singularities are not masked: the smallest wet cell is "
                f"{dx_wet.min():.3g} m wide (median {np.median(dx_wet):.3g} m). The "
                "barotropic substeps will violate CFL there and blow up; mask the two "
                "poles with bottom_height (see examples/bickley_jet_torch.py).",
                stacklevel=2)

    dt = grid.dtype
    if coriolis:
        f_ff = (2.0 * rotation_rate * torch.sin(torch.deg2rad(grid.phi_ff))).to(dt)
    else:
        f_ff = torch.zeros_like(grid.phi_ff)
    # kinematic wind stress sampled at the staggered velocity points, masked
    taux = tauy = torch.zeros(grid.shape2d, dtype=dt, device=grid.device)
    if wind_stress is not None:
        def at(a):
            return a.cpu().numpy().astype(np.float64)

        tx_u, _ = wind_stress(at(grid.lam_fc), at(grid.phi_fc))
        _, ty_v = wind_stress(at(grid.lam_cf), at(grid.phi_cf))
        taux = torch.as_tensor(np.broadcast_to(tx_u, grid.shape2d).copy()).to(
            device=grid.device, dtype=dt) * ib.mask_u
        tauy = torch.as_tensor(np.broadcast_to(ty_v, grid.shape2d).copy()).to(
            device=grid.device, dtype=dt) * ib.mask_v
    arrays = dict(
        inv_dx_fc=_inv(grid.dx_fc), inv_dy_cf=_inv(grid.dy_cf), inv_az_ff=_inv(grid.az_ff),
        inv_vol_c=ib.mask_c * _inv(grid.az_cc * ib.h_c),
        inv_dx_fc_e=_inv(grid_ext.dx_fc), inv_dy_cf_e=_inv(grid_ext.dy_cf),
        inv_az_cc_e=_inv(grid_ext.az_cc), dy_fc_e=grid_ext.dy_fc, dx_cf_e=grid_ext.dx_cf,
        h_u_e=ib_e.h_u, h_v_e=ib_e.h_v, mask_u_e=ib_e.mask_u, mask_v_e=ib_e.mask_v,
        weights=torch.as_tensor(free_surface.weights).to(device=grid.device, dtype=dt),
        f_ff=f_ff, taux=taux, tauy=tauy)

    # the kernels' prefactored closure planes (hydrostatic.py:438-468 of the JAX
    # package): the momentum pack without its two mask planes (they ride in
    # mom_pack), and the three κ_h planes appended to the tracer pack
    lay = []
    if nu_h > 0.0:
        m_ff_u = ib.mask_u * torch.roll(ib.mask_u, 1, dims=-2)
        m_ff_v = ib.mask_v * torch.roll(ib.mask_v, 1, dims=-1)
        lay += [nu_h * _ratio(grid.dy_cc, grid.dx_cc) * ib.mask_c,
                nu_h * _ratio(grid.dx_ff, grid.dy_ff) * m_ff_u,
                _inv(grid.az_fc) * ib.mask_u,
                nu_h * _ratio(grid.dy_ff, grid.dx_ff) * m_ff_v,
                nu_h * _ratio(grid.dx_cc, grid.dy_cc) * ib.mask_c,
                _inv(grid.az_cf) * ib.mask_v]
    if drag_type == "quadratic":
        cd = float(drag_coeff)
        lay += [cd * _inv(ib.h_u) * ib.mask_u, cd * _inv(ib.h_v) * ib.mask_v]
    kappa = None
    if kappa_h > 0.0:
        kappa = [kappa_h * _ratio(grid.dy_fc, grid.dx_fc) * ib.mask_u,
                 kappa_h * _ratio(grid.dx_cf, grid.dy_cf) * ib.mask_v,
                 _inv(grid.az_cc) * ib.mask_c]
    options = dict(forcing=tuple(forcing.items()), wind=wind_stress is not None,
                   drag_type=drag_type, drag_coeff=float(drag_coeff), nu_h=float(nu_h),
                   kappa_h=float(kappa_h), nu4_h=float(nu4_h), kappa4_h=float(kappa4_h))
    return HydrostaticModel(
        grid, grid_ext, ib, arrays, substeps=free_surface.substeps,
        fractional_dt=free_surface.fractional_dt,
        g=free_surface.gravitational_acceleration, coriolis=coriolis, options=options,
        mom_lay=torch.stack(lay) if lay else None, kappa=kappa)


def from_jax_arrays(arrays: dict, meta: dict, device) -> HydrostaticModel:
    """Build the port's model from a JAX package model's leaves.

    ``arrays`` maps each ``_MODEL_ARRAYS`` field of the JAX ``HydrostaticModel`` to
    ``np.asarray`` of its leaf; the grid, extended grid and immersed boundary
    contribute their fields under dotted keys (``"grid.dx_fc"``, ``"grid_ext.dx_fc"``,
    ``"ib.mask_c"``). ``meta`` holds the static fields the port reads (``substeps``,
    ``fractional_dt``, ``g``, ``coriolis``, ``tracer_advection``,
    ``momentum_advection``, ``tracer_names`` and ``OPTIONS``) and the two grids'
    metadata under ``"grid"`` and ``"grid_ext"``. The closure planes come from the
    JAX model's kernel packs: ``mom_lay`` less its two leading mask planes, and the
    last three planes of its (6-plane) column ``adv_pack`` with κ_h. User forcing
    functions must take tensors. Nothing is regenerated, so a step can be compared
    apart from grid generation."""
    _check_supported(meta["tracer_advection"], meta["momentum_advection"],
                     meta["tracer_names"])

    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(device)

    grids = {}
    for gname in ("grid", "grid_ext"):
        grids[gname] = TripolarGrid({n: t(f"{gname}.{n}") for n in ARRAY_FIELDS},
                                    {n: meta[gname][n] for n in META_FIELDS})
    ib = ImmersedBoundary({n: t(f"ib.{n}") for n in IB_FIELDS})
    lay = t("mom_lay")[2:]  # the JAX pack leads with [mask_u, mask_v]
    kappa = list(t("adv_pack")[3:6]) if meta["kappa_h"] > 0.0 else None
    return HydrostaticModel(
        grids["grid"], grids["grid_ext"], ib, {n: t(n) for n in DERIVED},
        substeps=meta["substeps"], fractional_dt=meta["fractional_dt"], g=meta["g"],
        coriolis=meta["coriolis"], options={n: meta[n] for n in OPTIONS},
        mom_lay=lay.contiguous() if lay.shape[0] else None, kappa=kappa)


def embed_ext(grid: TripolarGrid, grid_ext: TripolarGrid, A):
    """Zero-pad a base-halo array into the extended-halo layout."""
    dy = grid_ext.Hy - grid.Hy
    dx = grid_ext.Hx - grid.Hx
    return F.pad(A, (dx, dx, dy, dy))


def crop_ext(grid: TripolarGrid, grid_ext: TripolarGrid, A):
    dy = grid_ext.Hy - grid.Hy
    dx = grid_ext.Hx - grid.Hx
    return A[dy : dy + grid.Ny + 2 * grid.Hy, dx : dx + grid.Nx + 2 * grid.Hx]


def initial_state(model: HydrostaticModel, u=None, v=None, c=None, eta=None) -> State:
    """Initial state from functions of (λ, φ) in degrees, sampled at the staggered
    locations as stored (the reference's ``set!(model, u=uᵢ, ...)``); the halos start
    at 0 and everything is masked."""
    g = model.grid
    dt, dev = model.dtype, model.device

    def sample(fn, lam, phi):
        if fn is None:
            return torch.zeros(g.shape2d, dtype=dt, device=dev)
        lam = lam.cpu().numpy().astype(np.float64)
        phi = phi.cpu().numpy().astype(np.float64)
        out = np.broadcast_to(np.asarray(fn(lam, phi)), g.shape2d)
        full = np.zeros(g.shape2d)
        full[g.interior2d] = out[g.interior2d]
        return torch.as_tensor(full).to(device=dev, dtype=dt)

    ib = model.ib
    u0 = sample(u, g.lam_fc, g.phi_fc) * ib.mask_u
    v0 = sample(v, g.lam_cf, g.phi_cf) * ib.mask_v
    c0 = sample(c, g.lam_cc, g.phi_cc) * ib.mask_c
    eta0 = sample(eta, g.lam_cc, g.phi_cc) * ib.mask_c
    ge = model.grid_ext
    zero = torch.zeros(g.shape2d, dtype=dt, device=dev)
    return State(
        u=u0, v=v0, eta=embed_ext(g, ge, eta0), U=embed_ext(g, ge, ib.h_u * u0),
        V=embed_ext(g, ge, ib.h_v * v0), c=c0, Gu=zero, Gv=zero.clone(),
        Gc=torch.zeros_like(c0), t=torch.zeros((), dtype=dt, device=dev),
        iteration=torch.zeros((), dtype=torch.int32, device=dev))


def state_from_numpy(fields: dict, device) -> State:
    """A ``State`` from numpy arrays (e.g. ``np.asarray`` of a JAX state's fields)."""
    return State(**{f.name: torch.from_numpy(np.array(fields[f.name])).to(device)
                    for f in dataclasses.fields(State)})


def vorticity(model: HydrostaticModel, u, v):
    """ζ at FF: (δxᶠ(Δyᶜᶠ v) − δyᶠ(Δxᶠᶜ u)) / Azᶠᶠ of halo-filled u, v."""
    g = model.grid
    return (dxf(g.dy_cf * v) - dyf(g.dx_fc * u)) * model.inv_az_ff


class ForcingFields(NamedTuple):
    """Halo-filled prognostics handed to user forcing functions (relaxation and
    sponge terms read them); ``b`` is the prognostic buoyancy of the layered
    ``tracer_b`` mode (None elsewhere)."""

    u: Any
    v: Any
    c: Any
    b: Any = None


def tendencies(model: HydrostaticModel, u, v, c, t=0.0):
    """G_u, G_v (vector-invariant, no surface-pressure term) and G_c (flux-form
    WENO-5) of halo-filled fields, with the closures, wind, drag and forcing in the
    order of the JAX kernel path (``hydrostatic.py:655-757``): the kernels carry the
    advection, the mask, ν_h, quadratic drag and κ_h; wind, linear drag, the
    biharmonic terms and the forcing follow in torch. ``t`` is the model time handed
    to the forcing functions."""
    g, ib = model.grid, model.ib
    Gu, Gv = momentum.momentum(u, v, model.mom_pack, lay=model.mom_lay,
                               has_lap=model.nu_h > 0.0,
                               has_drag=model.drag_type == "quadratic")
    Gc = tracer_adv.tracer_adv(c, u, v, model.adv_pack)
    # surface stress and bottom drag act on the whole column: force / h
    if model.wind:
        Gu = Gu + model.taux * model.inv_h_u
        Gv = Gv + model.tauy * model.inv_h_v
    if model.drag_type == "linear":
        Gu = Gu - model.drag_coeff * u * model.inv_h_u * ib.mask_u
        Gv = Gv - model.drag_coeff * v * model.inv_h_v * ib.mask_v
    if model.nu4_h > 0.0:
        Gu = Gu - model.nu4_h * biharmonic_u(g, u, ib.mask_u, ib.mask_c)
        Gv = Gv - model.nu4_h * biharmonic_v(g, v, ib.mask_v, ib.mask_c)
    if model.kappa4_h > 0.0:
        Gc = Gc - model.kappa4_h * biharmonic_c(g, c, ib.mask_c, ib.mask_u, ib.mask_v)
    if model.forcing:
        fields = ForcingFields(u=u, v=v, c=c)
        for name, fn in model.forcing:
            if name == "u":
                Gu = Gu + fn(g.lam_fc, g.phi_fc, t, fields) * ib.mask_u
            elif name == "v":
                Gv = Gv + fn(g.lam_cf, g.phi_cf, t, fields) * ib.mask_v
            else:
                Gc = Gc + fn(g.lam_cc, g.phi_cc, t, fields) * ib.mask_c
    return Gu, Gv, Gc


def _fill(grid, A, loc, sign):
    """Halo fill into a fresh buffer (``A`` itself is left as it is)."""
    return halo_fill.fill_halos(A, loc, sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
                                inplace=False)


def barotropic_substeps(model: HydrostaticModel, eta, U, V, GU, GV, dt,
                        wrap_x_each_substep=True):
    """SM05-averaged forward-backward substepping of (η, U, V) on the extended-halo
    grid, with no exchange inside the loop (validity shrinks one cell per substep
    into the widened halo). ``dt`` is a 0-d tensor."""
    ge = model.grid_ext
    dtau = model.fractional_dt * dt
    return barotropic.barotropic_substeps(model.baro_pack, eta, U, V, GU, GV, dtau,
                                          model.weights, ge.Nx, ge.Hx,
                                          wrap_x_each_substep)


def step(model: HydrostaticModel, state: State, dt) -> State:
    """One time step (the reference call stack, SURVEY.md §3.4): halo fills, WENO
    tendencies, quasi-AB2 extrapolation, the exchange-free barotropic subcycle, the
    single-layer corrector (u = U/H) and the tracer update. ``state`` is not
    modified."""
    g, ge, ib = model.grid, model.grid_ext, model.ib
    # a number becomes a device scalar by a fill launch; copying it from the host
    # (torch.as_tensor) would wait for the stream to drain on every step
    dt = (dt.to(device=model.device, dtype=model.dtype) if torch.is_tensor(dt) else
          torch.full((), float(dt), dtype=model.dtype, device=model.device))

    u = _fill(g, state.u, FC, -1)
    v = _fill(g, state.v, CF, -1)
    c = _fill(g, state.c, CC, 1)
    eta_f = _fill(ge, state.eta, CC, 1)
    U_f = _fill(ge, state.U, FC, -1)
    V_f = _fill(ge, state.V, CF, -1)

    first = state.iteration == 0
    w1 = torch.where(first, model.ab2[0], model.ab2[2])
    w2 = torch.where(first, model.ab2[1], model.ab2[3])

    Gu, Gv, Gc = tendencies(model, u, v, c, t=state.t)
    Gu_s = w1 * Gu - w2 * state.Gu
    Gv_s = w1 * Gv - w2 * state.Gv
    Gc_s = w1 * Gc - w2 * state.Gc
    c_new = (state.c + dt * Gc_s) * ib.mask_c

    # depth-integrated forcing, valid through the widened halo after its fill
    GU_f = halo_fill.fill_halos(embed_ext(g, ge, ib.h_u * Gu_s), FC, -1, ge.Nx, ge.Ny,
                                ge.Hx, ge.Hy)
    GV_f = halo_fill.fill_halos(embed_ext(g, ge, ib.h_v * Gv_s), CF, -1, ge.Nx, ge.Ny,
                                ge.Hx, ge.Hy)

    # with the x-halo widened to >= n_sub + 1 the loop needs no per-substep x-wrap
    n_sub = model.weights.shape[0]
    eta_a, U_a, V_a = barotropic_substeps(model, eta_f, U_f, V_f, GU_f, GV_f, dt,
                                          wrap_x_each_substep=ge.Hx < n_sub + 1)

    # single-layer corrector: the velocity is the barotropic velocity
    u_new = crop_ext(g, ge, U_a) * model.inv_h_u * ib.mask_u
    v_new = crop_ext(g, ge, V_a) * model.inv_h_v * ib.mask_v
    return State(u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new, Gu=Gu, Gv=Gv,
                 Gc=Gc, t=state.t + dt, iteration=state.iteration + 1)


def compute_cfl_dt(model: HydrostaticModel, state: State, cfl=0.3):
    """Advective-CFL time step cfl / max(|u|/Δx + |v|/Δy), as a 0-d tensor on the
    model's device."""
    g = model.grid
    speed = torch.abs(state.u) * model.inv_dx_fc + torch.abs(state.v) * model.inv_dy_cf
    smax = torch.max(g.interior(speed))
    return torch.where(smax > 0, cfl / smax, torch.full_like(smax, float("inf")))


def multi_step(model: HydrostaticModel, state: State, dt, n_steps: int) -> State:
    """``n_steps`` time steps at a fixed ``dt``."""
    for _ in range(n_steps):
        state = step(model, state, dt)
    return state
