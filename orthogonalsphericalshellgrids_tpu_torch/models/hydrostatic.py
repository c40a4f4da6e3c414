"""Hydrostatic free-surface model on a tripolar grid (single-layer configuration).

Counterpart: ``orthogonalsphericalshellgrids_tpu/models/hydrostatic.py`` (``make_model``,
``initial_state``, ``vorticity``, ``ForcingFields``, ``tendencies``,
``embed_ext``/``crop_ext``, ``barotropic_substeps``, ``step``, ``multi_step``,
``compute_cfl_dt``) on its kernel path (``tend_kernels``):

- vector-invariant momentum with upwinded WENO-5 vorticity reconstruction
  (``momentum_advection="weno_vector_invariant"``, the momentum kernel) or the
  centered vorticity interpolation (``"vector_invariant"``, plain PyTorch),
- flux-form tracer advection of one tracer or a stack of several (``tracers``):
  WENO-5 through the tracer kernel (a stack in one launch over its planes), or WENO-7,
  third-order upwind, centered or fourth-order centered faces
  (``ops/advection.py:TRACER_SCHEMES``, plain PyTorch),
- split-explicit free surface with SM05-averaged forward-backward substeps integrated
  in widened halos, so the substep loop needs no exchange,
- quasi-Adams-Bashforth-2 time stepping (χ = 0.1, forward Euler on the first step),
- grid-fitted immersed-boundary masking, optional Coriolis,
- the closures ν_h, κ_h (fused into the momentum and tracer kernels as prefactored
  planes where those kernels run, else ``ops/closures.py``), ν4_h, κ4_h (biharmonic,
  plain PyTorch), kinematic wind stress, linear or quadratic bottom drag (quadratic
  fused into the momentum kernel) and user forcing, per tracer.

The model is an ``nn.Module`` whose arrays are registered buffers (metric reciprocals,
masks, column depths and the kernels' operand stacks, on the base and the extended
free-surface grid); the state is a frozen dataclass of tensors; the dynamics are
plain functions. The four hot operations go through ``kernels/``: on a CUDA device
they launch the hand-written kernels, on the CPU they run the plain PyTorch
versions. ``step`` fills the halos of the incoming state's prognostic fields in
place and writes their saved pre-fill strips back before it returns, and nothing
between the two reads the unfilled fields, so the state is bitwise unchanged on
return, also when the step raises; the output writer copies to the host on the
simulation thread, so no other stream sees the window.

With ``spmd`` (``ops/spmd.py``, ``ops/spmd2d.py``) ``step`` runs on one rank of a
y-partitioned run (``parallel/distributed.py``) or one block of a 2-D (x, y) mesh
(``parallel/distributed2d.py``): the same code on the rank's rows and columns, with
the fills exchanged (u, v, c, η, U, V with save, then GU and GV); the restore
follows the role's plan. With one shard it is the serial step, launch for launch.
On a sharded run the tendencies are split by default where that is exact
(``overlap``, ``overlap_supported``): the bulk pass reads the rank's own, unfilled
fields (locally x-wrapped on a y-partition) and is launched before the exchange;
the rows (and on a 2-D mesh the columns) within a halo of an exchanged edge are then
recomputed on 3·H-wide strips of the filled fields (``split_tendencies``), bitwise
equal to the unsplit step.

An ensemble (``models/ensemble.py``, the counterpart of ``jax.vmap(step)``) runs
through the same ``step``: every field of its ``State`` carries a leading member
axis B, and ``t`` and ``iteration`` are (B,) tensors. The group fills take the
member stacks as planes, the momentum and tracer kernels run every member in one
launch (the momentum kernel's layer loop; the tracer kernel's member mode), the
barotropic kernel over a member axis of its grid, and the AB2 weights are chosen per
member.
"""

from __future__ import annotations

import copy
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
from ..ops.advection import SCHEME_RADIUS, TRACER_SCHEMES, tracer_faces
from ..ops.closures import (_ratio, biharmonic_c, biharmonic_u, biharmonic_v,
                            laplacian_c, laplacian_u, laplacian_v)
from ..ops.location import CC, CF, FC
from ..ops.operators import dxc, dxf, dyc, dyf, ixc, ixf, iyc, iyf
from ..ops.spmd import GroupFill, Spmd, fill_group
from .split_explicit import SplitExplicitFreeSurface

__all__ = ["HydrostaticModel", "State", "ForcingFields", "make_model", "from_jax_arrays",
           "initial_state", "state_from_numpy", "vorticity", "centered_momentum",
           "tendencies",
           "overlap_radius", "overlap_supported", "strip_views", "split_tendencies",
           "tendencies_overlapped", "embed_ext", "crop_ext", "barotropic_substeps",
           "step", "multi_step", "compute_cfl_dt"]

_CHI = 0.1  # quasi-AB2 parameter (Oceananigans default)


@dataclasses.dataclass(frozen=True)
class State:
    """Prognostic state: u/v/c and the previous tendencies on base-halo arrays (c and
    Gc (Ye, Xe) for one tracer, the (n, Ye, Xe) stack in ``tracer_names`` order for
    several); η/U/V on extended-halo arrays; ``t`` and ``iteration`` are 0-d
    tensors. An ensemble's state (``models/ensemble.py``) has a leading member axis
    B on every field ((B, n, Ye, Xe) for several tracers) and (B,) ``t`` and
    ``iteration``."""

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
# the schemes, tracers, closure, wind, drag and forcing metadata (the JAX model's
# fields of those names)
OPTIONS = ("tracer_advection", "momentum_advection", "tracer_names", "forcing", "wind",
           "drag_type", "drag_coeff", "nu_h", "kappa_h", "nu4_h", "kappa4_h")


class HydrostaticModel(nn.Module):
    """Model configuration and precomputed arrays (registered buffers).

    ``grid``/``grid_ext`` are the base and extended-halo grids, ``ib`` the immersed
    boundary on the base grid. ``mom_pack``, ``adv_pack`` and ``baro_pack`` are the
    contiguous operand stacks of the momentum, tracer and barotropic kernels (plane
    order in ``kernels/*.STATIC_PLANES``; ``adv_pack`` ends with the κ_h planes
    ``kernels/tracer_adv.KAPPA_PLANES`` when κ_h > 0). ``mom_lay`` is the momentum
    kernel's closure pack (``kernels/momentum.LAP_PLANES`` with ν_h, then
    ``DRAG_PLANES`` with quadratic drag), None without either. ``options`` holds the
    ``OPTIONS`` metadata (``tracer_names`` the tuple of tracer names); ``kappa`` the
    three κ_h planes (None without κ_h)."""

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
    device="cuda",
) -> HydrostaticModel:
    """Assemble the model on ``device`` (where ``grid`` must lie; the card unless
    the caller asks for the CPU): widen the free-surface grid's halos to
    ``len(weights) + 1`` (``with_halo``, test/runtests.jl:58-71), precompute
    reciprocal metrics, masks and column depths on both grids, and the kernels'
    closure planes. A tripolar model requires an explicit free surface, as in the
    reference.

    ``tracers``: the tracer names (several stack ``State.c`` as (n, Ye, Xe)).
    ``tracer_advection``: one of ``TRACER_SCHEMES``, whose ``SCHEME_RADIUS`` the
    grid's halo must hold. ``momentum_advection``: "weno_vector_invariant" (upwinded
    WENO-5 vorticity) or "vector_invariant" (centered).
    ``forcing``: {target: fn}, target "u", "v" or a tracer's name, fn(λ°, φ°, t,
    fields) -> the tendency term, on tensors (``fields`` a ``ForcingFields`` of the
    halo-filled prognostics). ``wind_stress``: fn(λ°, φ°) -> (τx, τy), kinematic
    [m²/s²], on numpy arrays. ``bottom_drag``: ("linear", r [m/s]) or ("quadratic",
    Cd). ν_h, κ_h [m²/s] and ν4_h, κ4_h [m⁴/s]: the horizontal closures."""
    if free_surface is None:
        raise ValueError(
            "A tripolar-grid model requires an explicit SplitExplicitFreeSurface "
            "configuration (the reference rejects the default free surface too).")
    tracers = tuple(str(t) for t in tracers)
    if len(tracers) == 0 or len(set(tracers)) != len(tracers):
        raise ValueError(f"tracers must be a non-empty tuple of unique names, got {tracers!r}")
    if tracer_advection not in TRACER_SCHEMES:
        raise ValueError(
            f"unknown tracer_advection {tracer_advection!r}; options: {TRACER_SCHEMES}")
    radius = SCHEME_RADIUS[tracer_advection]
    if min(grid.Hx, grid.Hy) < radius:
        raise ValueError(
            f"tracer_advection={tracer_advection!r} consumes {radius} halo cells per "
            f"side but the grid halo is ({grid.Hx}, {grid.Hy}) — rebuild the grid "
            f"with halo >= {radius} (the reference widens halos the same way)")
    if (nu4_h > 0.0 or kappa4_h > 0.0) and min(grid.Hx, grid.Hy) < 2:
        raise ValueError(
            f"biharmonic closures (nu4_h/kappa4_h) consume 2 halo cells per side but "
            f"the grid halo is ({grid.Hx}, {grid.Hy}) — rebuild the grid with halo >= 2")
    forcing = dict(forcing or {})
    valid_targets = {"u", "v", *tracers}
    unknown = set(forcing) - valid_targets
    if unknown:
        raise ValueError(f"forcing targets {sorted(unknown)} not in {sorted(valid_targets)}")
    drag_type, drag_coeff = ("none", 0.0) if bottom_drag is None else bottom_drag
    if drag_type not in ("none", "linear", "quadratic"):
        raise ValueError(f"bottom_drag type must be linear|quadratic, got {drag_type!r}")
    dev = torch.device(device)
    if dev.type != grid.device.type or dev.index not in (None, grid.device.index):
        raise ValueError(f"make_model(device={device!r}) but the grid lies on "
                         f"{grid.device}")
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
    options = dict(tracer_advection=tracer_advection,
                   momentum_advection=momentum_advection, tracer_names=tracers,
                   forcing=tuple(forcing.items()), wind=wind_stress is not None,
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
    """The base-halo window of an extended-halo array (a view; any leading axes)."""
    dy = grid_ext.Hy - grid.Hy
    dx = grid_ext.Hx - grid.Hx
    return A[..., dy : dy + grid.Ny + 2 * grid.Hy, dx : dx + grid.Nx + 2 * grid.Hx]


def initial_state(model: HydrostaticModel, u=None, v=None, c=None, eta=None) -> State:
    """Initial state from functions of (λ, φ) in degrees, sampled at the staggered
    locations as stored (the reference's ``set!(model, u=uᵢ, ...)``); the halos start
    at 0 and everything is masked. With several tracers ``c`` is a dict ``{name:
    fn}`` (missing names start at 0) or a sequence of functions in ``tracer_names``
    order, and ``State.c`` the (n, Ye, Xe) stack."""
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

    names = model.tracer_names
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
        c_raw = torch.stack([sample(fn, g.lam_cc, g.phi_cc) for fn in fns])
        if len(names) == 1:
            c_raw = c_raw[0]

    ib = model.ib
    u0 = sample(u, g.lam_fc, g.phi_fc) * ib.mask_u
    v0 = sample(v, g.lam_cf, g.phi_cf) * ib.mask_v
    c0 = c_raw * ib.mask_c
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


def centered_momentum(model: HydrostaticModel, u, v):
    """G_u, G_v of the vector-invariant momentum with the vorticity interpolated
    centered (``momentum_advection="vector_invariant"``; ``hydrostatic.py:670-690``
    and ``layered.py:672-689`` of the JAX package), before the mask; halo-filled u
    and v, one layer or a stack."""
    g = model.grid
    zeta = vorticity(model, u, v)
    q = zeta + model.f_ff if model.coriolis else zeta
    v_hat = ixf(iyc(g.dx_cf * v)) * model.inv_dx_fc
    ke = 0.5 * (ixc(u * u) + iyc(v * v))
    Gu = iyc(q) * v_hat - dxf(ke) * model.inv_dx_fc
    u_hat = iyf(ixc(g.dy_fc * u)) * model.inv_dy_cf
    Gv = -ixc(q) * u_hat - dyf(ke) * model.inv_dy_cf
    return Gu, Gv


def tendencies(model: HydrostaticModel, u, v, c, t=0.0, out=None):
    """G_u, G_v (vector-invariant, no surface-pressure term) and G_c (flux form, one
    plane or the stack of ``c``) of halo-filled fields, with the closures, wind, drag
    and forcing in the order of the JAX package's kernel path
    (``hydrostatic.py:643-757``): the momentum kernel (with the upwinded WENO
    vorticity) carries the advection, the mask, ν_h and quadratic drag, the tracer
    kernel (WENO-5) the advection of every plane and κ_h; the centered momentum, the
    other tracer schemes and the closures those kernels do not carry, wind, linear
    drag, the biharmonic terms and the forcing (a tracer's into its own plane) follow
    in torch. ``t`` is the model time handed to the forcing functions. u, v and c
    may carry a leading member axis (an ensemble; then ``t`` is (B, 1, 1)). ``out``
    = (Gu, Gv, Gc) buffers receives the tendencies: the kernels write them there,
    and a tendency that a torch term replaced is copied in."""
    g, ib = model.grid, model.ib
    outs = (None,) * 3 if out is None else tuple(out)
    mom_kernel = model.momentum_advection == "weno_vector_invariant"
    adv_kernel = model.tracer_advection == "weno5"
    if mom_kernel:  # members are the kernel's layers, sharing one closure pack
        Gu, Gv = momentum.momentum(u, v, model.mom_pack, lay=model.mom_lay,
                                   has_lap=model.nu_h > 0.0,
                                   has_drag=model.drag_type == "quadratic",
                                   period=1, out=None if out is None else outs[:2])
    else:
        Gu, Gv = centered_momentum(model, u, v)
        Gu, Gv = Gu * ib.mask_u, Gv * ib.mask_v
    if adv_kernel:
        Gc = tracer_adv.tracer_adv(c, u, v, model.adv_pack, out=outs[2])
    else:
        # the velocities at the tracer planes: a member's planes over its own pair
        uc, vc = (a.reshape(a.shape[:-2] + (1,) * (c.dim() - a.dim()) + a.shape[-2:])
                  for a in (u, v))
        cx = tracer_faces(c, uc, axis=-1, scheme=model.tracer_advection)
        cy = tracer_faces(c, vc, axis=-2, scheme=model.tracer_advection)
        fx = uc * ib.h_u * g.dy_fc * cx
        fy = vc * ib.h_v * g.dx_cf * cy
        Gc = -(dxc(fx) + dyc(fy)) * model.inv_vol_c
    # surface stress and bottom drag act on the whole column: force / h
    if model.wind:
        Gu = Gu + model.taux * model.inv_h_u
        Gv = Gv + model.tauy * model.inv_h_v
    if model.drag_type == "linear":
        Gu = Gu - model.drag_coeff * u * model.inv_h_u * ib.mask_u
        Gv = Gv - model.drag_coeff * v * model.inv_h_v * ib.mask_v
    elif model.drag_type == "quadratic" and not mom_kernel:
        sp_u = torch.sqrt(u * u + ixf(iyc(v)) ** 2)
        sp_v = torch.sqrt(v * v + iyf(ixc(u)) ** 2)
        Gu = Gu - model.drag_coeff * sp_u * u * model.inv_h_u * ib.mask_u
        Gv = Gv - model.drag_coeff * sp_v * v * model.inv_h_v * ib.mask_v
    if model.nu_h > 0.0 and not mom_kernel:
        Gu = Gu + model.nu_h * laplacian_u(g, u, ib.mask_u, ib.mask_c)
        Gv = Gv + model.nu_h * laplacian_v(g, v, ib.mask_v, ib.mask_c)
    if model.kappa_h > 0.0 and not adv_kernel:
        Gc = Gc + model.kappa_h * laplacian_c(g, c, ib.mask_c, ib.mask_u, ib.mask_v)
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
            elif len(model.tracer_names) == 1:
                Gc = Gc + fn(g.lam_cc, g.phi_cc, t, fields) * ib.mask_c
            else:  # Gc is a fresh tensor
                Gc[..., model.tracer_names.index(name), :, :] += fn(
                    g.lam_cc, g.phi_cc, t, fields) * ib.mask_c
    return _place(outs, (Gu, Gv, Gc))


def _place(outs, results):
    """Each of ``results`` in its buffer of ``outs`` (a None buffer keeps the result
    as it is): a result that lies there already is kept, another is copied in."""
    return tuple(r if o is None or (o.data_ptr() == r.data_ptr() and o.shape == r.shape
                                    and o.stride() == r.stride()) else o.copy_(r)
                 for o, r in zip(outs, results))


def _into(out, state):
    """``state`` with every field in its buffer of the state ``out`` (``_place``), or
    ``state`` itself when ``out`` is None: a step that writes into given buffers, as
    ``utils/graph.py``'s blocks chain two of them, returns ``out``."""
    if out is None:
        return state
    names = [f.name for f in dataclasses.fields(state)]
    _place([getattr(out, n) for n in names], [getattr(state, n) for n in names])
    return out


def _averages(out):
    """The (3,) + η.shape buffer whose consecutive views ``out``'s η, U and V are (the
    barotropic averages' layout), or None."""
    base = None if out is None else out.eta._base
    if base is None or tuple(base.shape) != (3,) + tuple(out.eta.shape) or \
            not base.is_contiguous():
        return None
    views = (out.eta, out.U, out.V)
    if all(a._base is base and a.data_ptr() == base[i].data_ptr() and a.is_contiguous()
           for i, a in enumerate(views)):
        return base
    return None


# --------------------------------------------------------------------------------------
# The interior/boundary overlap split of a sharded step
# --------------------------------------------------------------------------------------

def _sliced(module, rows, cols, prefix=""):
    """A view of ``module`` (a model or one of its grids) whose base-layout buffers
    (``parallel/layouts.py``) hold rows ``rows`` and columns ``cols`` of every plane,
    as contiguous copies; every other buffer and attribute is the module's own."""
    from ..parallel import layouts  # parallel imports this module

    def sl(name, buf):
        if buf is None or buf.dim() < 2 or layouts.leaf_layout(name) != layouts.BASE:
            return buf
        return buf[..., rows, cols].contiguous()

    view = copy.copy(module)
    view.__dict__.pop("_strip_views", None)
    view._buffers = {n: sl(prefix + n, b) for n, b in module._buffers.items()}
    view._modules = {n: _sliced(m, rows, cols, f"{prefix}{n}.")
                     for n, m in module._modules.items()}
    return view


def strip_views(model, two_d):
    """The models the split's strip passes run on (``_model_rows`` and
    ``_model_cols`` of the JAX package): rows [0, 3·Hy) and [Ny - Hy, Ny + 2·Hy),
    and on a 2-D mesh (``two_d``) columns [0, 3·Hx) and [Nx - Hx, Nx + 2·Hx), of
    every base-layout buffer. Built once a model (``parallel/distributed.py`` and
    ``distributed2d.py`` build them with the shards) and kept on it."""
    cache = model.__dict__.setdefault("_strip_views", {})
    if two_d not in cache:
        g = model.grid
        full = slice(None)
        views = [_sliced(model, slice(r0, r0 + 3 * g.Hy), full)
                 for r0 in (0, g.Ny - g.Hy)]
        if two_d:
            views += [_sliced(model, full, slice(c0, c0 + 3 * g.Hx))
                      for c0 in (0, g.Nx - g.Hx)]
        cache[two_d] = tuple(views)
    return cache[two_d]


def overlap_radius(model) -> int:
    """The horizontal stencil radius of one tendency evaluation (the rows or columns
    a tendency at a cell reads beyond it; ``hydrostatic.py:788-800`` of the JAX
    package): the tracer scheme's ``SCHEME_RADIUS`` (a flux divergence reads no
    further than its faces' reconstruction), or the momentum's, 3 for the WENO-5
    vorticity reconstruction of radius-1 curls and 2 for the centered one, whichever
    is larger; the closures (biharmonic: 2) and the vertical terms (column-local)
    reach no further."""
    r_mom = 3 if model.momentum_advection == "weno_vector_invariant" else 2
    return max(r_mom, SCHEME_RADIUS[model.tracer_advection])


def overlap_supported(model, grid) -> bool:
    """Whether the split is exact on ``grid`` (``hydrostatic.py:803`` of the JAX
    package): a kept bulk cell must read only cells that the exchange does not
    change, which needs radius <= Hy - 1 in y (the fold rewrites half of the last
    interior row) and radius <= Hx in x, and Ny >= Hy keeps the 3·Hy-row strips in
    bounds."""
    r = overlap_radius(model)
    return r <= grid.Hy - 1 and r <= grid.Hx and grid.Ny >= grid.Hy


def _resolve_overlap(model, grid, spmd, overlap):
    """The JAX package's default (on when the run is sharded and the split exact)
    and its refusal of ``overlap=True`` where the split is not exact."""
    if overlap is None:
        return spmd is not None and spmd.n_shards > 1 and overlap_supported(model, grid)
    if overlap and not overlap_supported(model, grid):
        raise ValueError(
            f"overlap split is not exact for this configuration: effective stencil "
            f"radius {overlap_radius(model)} needs Hy >= radius+1 and Hx >= radius "
            f"(grid halo is ({grid.Hx}, {grid.Hy})) — widen the halo or pass "
            "overlap=False")
    if overlap and (spmd is None or spmd.n_shards == 1):
        raise ValueError("overlap=True splits a sharded step; this step has one shard")
    return bool(overlap)


def split_tendencies(model, groups, spmd, tend_from_groups, t, fill):
    """The interior/boundary split of a sharded tendency evaluation
    (``hydrostatic.py:821-904`` of the JAX package):

    - the bulk pass ``tend_from_groups(model, groups, t)`` reads the rank's own
      fields as they are (after ``fill``'s local x-wrap on a y-partition; an
      x-block's x halos are remote) and is launched first;
    - ``fill.fill()`` then exchanges and fills the group in place;
    - the Hy interior rows at each y end, and on a 2-D mesh the Hx interior columns
      at each x end, are recomputed on 3·H-wide strips of the filled fields (copied
      contiguous) with the ``strip_views`` models and written into the bulk
      tendencies: rows first, then the columns, which cover all rows, so that the
      corners come from the filled fields.

    A kept bulk cell reads only cells the exchange leaves as they are
    (``overlap_supported``), and a patched cell reads the same filled cells as the
    unsplit step, so the result is the unsplit step's, bitwise. ``groups`` are the
    tensors the tendencies read; returns the tuple of tendencies."""
    g = model.grid
    Hy, ny, Hx, nx = g.Hy, g.Ny, g.Hx, g.Nx
    two_d = not isinstance(spmd, Spmd)
    G = tend_from_groups(model, groups, t)
    fill.fill()
    views = strip_views(model, two_d)

    def strip(view, rows, cols):
        return tend_from_groups(view, [gr[..., rows, cols].contiguous() for gr in groups],
                                t)

    full = slice(None)
    lo = strip(views[0], slice(0, 3 * Hy), full)  # interior rows [Hy, 2Hy)
    hi = strip(views[1], slice(ny - Hy, ny + 2 * Hy), full)  # [ny, ny + Hy), row Ny
    for b, l, h in zip(G, lo, hi):
        b[..., Hy:2 * Hy, :] = l[..., Hy:2 * Hy, :]
        b[..., ny:ny + Hy, :] = h[..., Hy:2 * Hy, :]
    if two_d:
        w = strip(views[2], full, slice(0, 3 * Hx))  # interior columns [Hx, 2Hx)
        e = strip(views[3], full, slice(nx - Hx, nx + 2 * Hx))  # [nx, nx + Hx)
        for b, l, h in zip(G, w, e):
            b[..., :, Hx:2 * Hx] = l[..., :, Hx:2 * Hx]
            b[..., :, nx:nx + Hx] = h[..., :, Hx:2 * Hx]
    return G


def tendencies_overlapped(model: HydrostaticModel, state: State, spmd, fill, t):
    """The single-layer tendencies (Gu, Gv, Gc) of a sharded step, split
    (``split_tendencies``); ``fill`` is the step's ``ops/spmd.GroupFill`` of the
    state's group, ``t`` the time the forcing reads (``step``'s)."""
    def tend(m, views, t):
        return tendencies(m, *views, t=t)

    return split_tendencies(model, [state.u, state.v, state.c], spmd, tend, t, fill)


def _fill(grid, A, loc, sign):
    """Halo fill into a fresh buffer (``A`` itself is left as it is)."""
    return halo_fill.fill_halos(A, loc, sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy,
                                inplace=False)


def _forcing_ext(grid_ext: TripolarGrid, GU, GV, spmd=None):
    """Fill the halos of the step's own extended-grid forcing planes GU (face-x) and
    GV (face-y) in place, one group (exchanged on a rank of ``spmd``); returns them."""
    ext = (grid_ext.Nx, grid_ext.Ny, grid_ext.Hx, grid_ext.Hy)
    return fill_group([(GU, FC, -1, *ext), (GV, CF, -1, *ext)], spmd)[0]


def barotropic_substeps(model: HydrostaticModel, eta, U, V, GU, GV, dt,
                        wrap_x_each_substep=True, out=None):
    """SM05-averaged forward-backward substepping of (η, U, V) on the extended-halo
    grid, with no exchange inside the loop (validity shrinks one cell per substep
    into the widened halo). ``dt`` is a 0-d tensor; ``out`` a (3,) + η.shape buffer
    for the averages, or None."""
    ge = model.grid_ext
    dtau = model.fractional_dt * dt
    return barotropic.barotropic_substeps(model.baro_pack, eta, U, V, GU, GV, dtau,
                                          model.weights, ge.Nx, ge.Hx,
                                          wrap_x_each_substep, out=out)


def step(model: HydrostaticModel, state: State, dt, spmd=None, overlap=None,
         out=None) -> State:
    """One time step (the reference call stack, SURVEY.md §3.4): halo fills, WENO
    tendencies, quasi-AB2 extrapolation, the exchange-free barotropic subcycle, the
    single-layer corrector (u = U/H) and the tracer update.

    The halos of ``state``'s u, v, c, η, U and V are filled in place, their pre-fill
    strips saved (one group fill), and written back (one restore) after the
    barotropic subcycle, the last reader of the filled fields, and before anything
    reads the unfilled ones; the restore runs even when the step raises. ``state``
    is bitwise unchanged on return.

    ``spmd`` (``ops/spmd.Spmd`` or ``ops/spmd2d.Spmd2D``) runs the step on one rank
    of a y-partitioned run or one block of a 2-D mesh: ``model`` and ``state`` are
    the rank's (``parallel/distributed.py``, ``distributed2d.py``), and both fills
    exchange with the neighbouring ranks. ``overlap`` splits the tendencies
    (``split_tendencies``): by default on a sharded run where ``overlap_supported``;
    True where the split is not exact raises.

    An ensemble's ``state`` (a leading member axis, ``models/ensemble.py``) steps
    every member at once, each with its own AB2 weights, at one ``dt``, serial or on
    a rank (``distribute``'s shards of a member batch); the forcing reads each
    member's time as (B, 1, 1) on both routes of the tendencies.

    ``out``, a state of buffers shaped like ``state`` (η, U and V the views of one
    (3,) + η.shape buffer), receives the new state and is returned: the kernels and
    the last torch operation of each field write it there, bitwise the state a step
    without ``out`` returns, and a field that some option computes otherwise is
    copied in (``_into``). It must share no storage with ``state``."""
    g, ge, ib = model.grid, model.grid_ext, model.ib
    t = state.t.reshape(-1, 1, 1) if state.t.dim() == 1 else state.t
    overlap = _resolve_overlap(model, g, spmd, overlap)
    # a number becomes a device scalar by a fill launch; copying it from the host
    # (torch.as_tensor) would wait for the stream to drain on every step
    dt = (dt.to(device=model.device, dtype=model.dtype) if torch.is_tensor(dt) else
          torch.full((), float(dt), dtype=model.dtype, device=model.device))

    base, ext = (g.Nx, g.Ny, g.Hx, g.Hy), (ge.Nx, ge.Ny, ge.Hx, ge.Hy)
    c_planes = state.c.flatten(0, -3) if state.c.dim() > 3 else state.c
    fields = [(state.u, FC, -1, *base), (state.v, CF, -1, *base), (c_planes, CC, 1, *base),
              (state.eta, CC, 1, *ext), (state.U, FC, -1, *ext), (state.V, CF, -1, *ext)]
    fill = GroupFill(fields, spmd, wrap=overlap)
    try:
        first = state.iteration == 0
        w1 = torch.where(first, model.ab2[0], model.ab2[2])
        w2 = torch.where(first, model.ab2[1], model.ab2[3])

        if overlap:
            Gu, Gv, Gc = tendencies_overlapped(model, state, spmd, fill, t)
        else:
            fill.fill()
            Gu, Gv, Gc = tendencies(model, state.u, state.v, state.c, t=t,
                                    out=None if out is None else (out.Gu, out.Gv, out.Gc))
        Gu_s = _lead(w1, Gu) * Gu - _lead(w2, Gu) * state.Gu
        Gv_s = _lead(w1, Gv) * Gv - _lead(w2, Gv) * state.Gv
        Gc_s = _lead(w1, Gc) * Gc - _lead(w2, Gc) * state.Gc

        # depth-integrated forcing, valid through the widened halo after its fill
        GU, GV = _forcing_ext(ge, embed_ext(g, ge, ib.h_u * Gu_s),
                              embed_ext(g, ge, ib.h_v * Gv_s), spmd)

        # with the x-halo widened to >= n_sub + 1 the loop needs no per-substep x-wrap
        n_sub = model.weights.shape[0]
        eta_a, U_a, V_a = barotropic_substeps(model, state.eta, state.U, state.V, GU, GV,
                                              dt, wrap_x_each_substep=ge.Hx < n_sub + 1,
                                              out=_averages(out))
    finally:
        fill.restore()
    o = (None,) * 5 if out is None else (out.u, out.v, out.c, out.t, out.iteration)
    c_new = torch.mul(state.c + dt * Gc_s, ib.mask_c, out=o[2])

    # single-layer corrector: the velocity is the barotropic velocity
    u_new = torch.mul(crop_ext(g, ge, U_a) * model.inv_h_u, ib.mask_u, out=o[0])
    v_new = torch.mul(crop_ext(g, ge, V_a) * model.inv_h_v, ib.mask_v, out=o[1])
    return _into(out, State(u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new, Gu=Gu,
                           Gv=Gv, Gc=Gc, t=torch.add(state.t, dt, out=o[3]),
                           iteration=torch.add(state.iteration, 1, out=o[4])))


def _lead(w, A):
    """A 0-d weight as it is; an ensemble's (B,) weights shaped to broadcast over the
    member axis of ``A``."""
    return w if w.dim() == 0 else w.reshape(w.shape + (1,) * (A.dim() - 1))


def compute_cfl_dt(model: HydrostaticModel, state: State, cfl=0.3):
    """Advective-CFL time step cfl / max(|u|/Δx + |v|/Δy), as a 0-d tensor on the
    model's device; an ensemble's as a (B,) tensor, one per member."""
    g = model.grid
    speed = torch.abs(state.u) * model.inv_dx_fc + torch.abs(state.v) * model.inv_dy_cf
    smax = torch.amax(g.interior(speed), dim=(-2, -1))
    return torch.where(smax > 0, cfl / smax, torch.full_like(smax, float("inf")))


def multi_step(model: HydrostaticModel, state: State, dt, n_steps: int) -> State:
    """``n_steps`` time steps at a fixed ``dt`` (a number or a 0-d tensor): the eager
    loop of ``step`` on the CPU, replays of the model's captured CUDA graphs of the
    step on a card (``utils/graph.py``, the counterpart of the JAX package's jitted
    ``lax.scan``), bitwise equal to the loop."""
    from ..utils import graph

    return graph.run(step, model, state, dt, n_steps)
