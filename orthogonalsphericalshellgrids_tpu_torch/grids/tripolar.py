"""Tripolar grid construction (Murray 1996 cofocal ellipse/hyperbola mapping).

Counterpart: ``orthogonalsphericalshellgrids_tpu/grids/tripolar.py``
(``_murray_mapping``, ``build_tripolar_arrays``, ``TripolarGrid.make``,
``with_halo``); the reference constructor is ``src/tripolar_grid.jl:59-333``.

Generation runs on the host in float64 numpy, exactly as in the JAX package's numpy
path, whatever the grid size; ``TripolarGrid.make`` then casts every array to the
model dtype on the requested device, where it is a registered buffer of an
``nn.Module``. Two options of the JAX package are not ported yet and raise
``NotImplementedError`` (ROADMAP queue 1): ``phi_spacing`` (its Newton solve
differentiates through a ``lax.scan``) and the native C++ generation backend.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import zipper
from ..ops.location import CC, CF, FC, FF
from . import geometry as geo
from .latlon import latlon_metrics_1d

__all__ = ["TripolarGrid", "build_tripolar_arrays", "with_halo"]


# Degree-exact trigonometry (Julia's sind/cosd/tand are exact at multiples of 90°; the
# Murray mapping's north-pole special case relies on x and y being exactly zero there).

def _sind(x):
    x = np.asarray(x, dtype=np.float64)
    r = np.mod(x, 360.0)
    out = np.sin(np.radians(r))
    # signed zeros at multiples of 180° (Julia's sinpi convention): the sign of the
    # zero decides the atan(y/x) branch on the λ = ±180 meridian
    out = np.where(np.mod(r, 180.0) == 0.0, np.copysign(0.0, x), out)
    out = np.where(r == 90.0, 1.0, out)
    out = np.where(r == 270.0, -1.0, out)
    return out


def _cosd(x):
    return _sind(np.asarray(x, dtype=np.float64) + 90.0)


def _tand(x):
    return _sind(x) / _cosd(x)


def _murray_mapping(lam1d, phi1d, Nx, focal_distance, first_pole_longitude):
    """Closed-form Murray mapping at one staggered location over the (Ny, Nx) index
    space, layout [j, i] (``src/generate_tripolar_coordinates.jl:53-89``). Returns
    (λ2D, φ2D) in degrees."""
    lam = np.asarray(lam1d, dtype=np.float64)[None, :]
    phi = np.asarray(phi1d, dtype=np.float64)[:, None]
    a = focal_distance

    psi = np.arcsinh(_tand((90.0 - phi) / 2.0) / a)
    x = a * _sind(lam) * np.cosh(psi)
    y = a * _cosd(lam) * np.sinh(psi)

    with np.errstate(divide="ignore", invalid="ignore"):
        lam2 = -(180.0 / math.pi) * np.arctan(y / x)

    # exactly at the north pole the longitude is undefined: take the value continuous
    # with the neighbours (reference lines :74-77), tested on the 1-D longitude so a
    # circshifted input gives the circshifted output
    on_pole = (x == 0.0) & (y == 0.0)
    lam2 = np.where(on_pole, np.where(lam == -180.0, -90.0, 90.0), lam2)

    phi2 = 90.0 - (360.0 / math.pi) * np.arctan(np.sqrt(x * x + y * y))

    lam2 = lam2 + np.where(lam < 0.0, -90.0, 90.0)
    lam2 = lam2 + first_pole_longitude + 90.0
    lam2 = geo.convert_to_0_360(lam2)
    return lam2, phi2


def _embed_with_halo(interior_yx, Hx, Hy):
    """Embed an interior (Ny, Nx) array into a halo-inclusive one, halo zeroed."""
    Ny, Nx = interior_yx.shape
    out = np.empty((Ny + 2 * Hy, Nx + 2 * Hx), dtype=interior_yx.dtype)
    out[:Hy, :] = 0.0
    out[Hy + Ny :, :] = 0.0
    out[:, :Hx] = 0.0
    out[:, Hx + Nx :] = 0.0
    out[Hy : Hy + Ny, Hx : Hx + Nx] = interior_yx
    return out


def _fill_coord_halos(A, loc, Nx, Ny, Hx, Hy):
    """Coordinate/metric halo fill: zipper(+1) north, periodic x, open south
    (``src/tripolar_grid.jl:147-152``), in place into the fresh buffer."""
    return zipper.fill_halos(A, loc, 1, Nx, Ny, Hx, Hy, south="none", inplace=True)


def build_tripolar_arrays(
    size,
    southernmost_latitude=-80.0,
    halo=(4, 4, 4),
    radius=geo.R_EARTH,
    z=(0.0, 1.0),
    north_poles_latitude=55.0,
    first_pole_longitude=70.0,
    backend="numpy",
    phi_spacing=None,
):
    """All tripolar coordinate/metric arrays in float64 numpy: a dict of
    halo-inclusive (Ny+2Hy, Nx+2Hx) arrays for the 8 coordinates and 12 metrics, the
    1-D z data, and ``meta``. Keyword names and defaults follow the reference
    constructor (``src/tripolar_grid.jl:59-66``)."""
    if phi_spacing is not None:
        raise NotImplementedError(
            "phi_spacing (newton_phi_nodes) is not ported yet: ROADMAP queue 1, "
            "deferred slice options")
    if backend != "numpy":
        raise NotImplementedError(
            f"grid-generation backend {backend!r} is not ported yet (the native C++ "
            "backend, grids/native.py): ROADMAP queue 1, deferred slice options")
    Nx, Ny, Nz = size
    Hx, Hy, Hz = halo
    if Nx % 2 != 0:
        raise ValueError("The number of cells in the longitude dimension should be even!")
    if not (0 < Hx <= Nx and 0 < Hy <= Ny):
        raise ValueError(f"halo {halo} must be positive and no larger than size {size}")

    focal_distance = _tand((90.0 - north_poles_latitude) / 2.0)

    # 1-D coordinates (src/tripolar_grid.jl:90-97); λ faces start at -180
    dlam = 360.0 / Nx
    lamF1 = -180.0 + dlam * np.arange(Nx, dtype=np.float64)
    lamC1 = lamF1 + dlam / 2.0
    phiC1 = np.linspace(southernmost_latitude, 90.0, Ny)
    dphi = phiC1[1] - phiC1[0]
    phiF1 = phiC1 - dphi / 2.0

    def mapper(l1, p1):
        return _murray_mapping(l1, p1, Nx, focal_distance, first_pole_longitude)

    # circshift by Nλ÷4 puts pole 1 at i=1 and pole 2 at i=Nλ/2+1
    # (src/tripolar_grid.jl:119-130), done as a roll of the 1-D inputs
    shift = Nx // 4
    lamF1 = np.roll(lamF1, shift)
    lamC1 = np.roll(lamC1, shift)

    lam_ff, phi_ff = mapper(lamF1, phiF1)
    lam_fc, phi_fc = mapper(lamF1, phiC1)
    lam_cf, phi_cf = mapper(lamC1, phiF1)
    lam_cc, phi_cc = mapper(lamC1, phiC1)

    coords = {
        "lam_ff": lam_ff, "phi_ff": phi_ff, "lam_fc": lam_fc, "phi_fc": phi_fc,
        "lam_cf": lam_cf, "phi_cf": phi_cf, "lam_cc": lam_cc, "phi_cc": phi_cc,
    }
    loc_of = {"ff": FF, "fc": FC, "cf": CF, "cc": CC}
    for name in list(coords):
        loc = loc_of[name.split("_")[1]]
        coords[name] = _fill_coord_halos(_embed_with_halo(coords[name], Hx, Hy), loc,
                                         Nx, Ny, Hx, Hy)

    lamFF, phiFF = coords["lam_ff"], coords["phi_ff"]
    lamFC, phiFC = coords["lam_fc"], coords["phi_fc"]
    lamCF, phiCF = coords["lam_cf"], coords["phi_cf"]
    lamCC, phiCC = coords["lam_cc"], coords["phi_cc"]

    # metric terms over the interior (src/tripolar_grid_utils.jl:4-45)
    J = slice(Hy, Hy + Ny)
    Jp = slice(Hy + 1, Hy + Ny + 1)
    Jm = slice(Hy - 1, Hy + Ny - 1)
    I = slice(Hx, Hx + Nx)
    Ip = slice(Hx + 1, Hx + Nx + 1)
    Im = slice(Hx - 1, Hx + Nx - 1)

    def hav(lam, phi, Ja, Ia, Jb, Ib):
        return geo.haversine(lam[Ja, Ia], phi[Ja, Ia], lam[Jb, Ib], phi[Jb, Ib], radius,
                             xp=np)

    def cart(phi, lam, Ja, Ia):
        return geo.lat_lon_to_cartesian(phi[Ja, Ia], lam[Ja, Ia], 1.0, xp=np)

    dx_cc = hav(lamFC, phiFC, J, Ip, J, I)
    dx_fc = hav(lamCC, phiCC, J, I, J, Im)
    dx_cf = hav(lamFF, phiFF, J, Ip, J, I)
    dx_ff = hav(lamCF, phiCF, J, I, J, Im)
    dy_cc = hav(lamCF, phiCF, Jp, I, J, I)
    dy_fc = hav(lamFF, phiFF, Jp, I, J, I)
    dy_cf = hav(lamCC, phiCC, J, I, Jm, I)
    dy_ff = hav(lamFC, phiFC, J, I, Jm, I)
    az_cc = geo.spherical_area_quadrilateral(
        cart(phiFF, lamFF, J, I), cart(phiFF, lamFF, J, Ip),
        cart(phiFF, lamFF, Jp, Ip), cart(phiFF, lamFF, Jp, I), xp=np,
    ) * radius**2
    az_fc = dy_fc * dx_fc
    az_cf = dy_cf * dx_cf
    az_ff = geo.spherical_area_quadrilateral(
        cart(phiCC, lamCC, Jm, Im), cart(phiCC, lamCC, Jm, I),
        cart(phiCC, lamCC, J, I), cart(phiCC, lamCC, J, Im), xp=np,
    ) * radius**2

    metrics = {
        "dx_cc": dx_cc, "dx_fc": dx_fc, "dx_cf": dx_cf, "dx_ff": dx_ff,
        "dy_cc": dy_cc, "dy_fc": dy_fc, "dy_cf": dy_cf, "dy_ff": dy_ff,
        "az_cc": az_cc, "az_fc": az_fc, "az_cf": az_cf, "az_ff": az_ff,
    }
    for name in list(metrics):
        loc = loc_of[name.split("_")[1]]
        metrics[name] = _fill_coord_halos(_embed_with_halo(metrics[name], Hx, Hy), loc,
                                          Nx, Ny, Hx, Hy)

    # south continuation with closed-form LatitudeLongitudeGrid metrics
    # (src/tripolar_grid.jl:277-300), south halo plus interior row 1, all columns
    j_cont = np.arange(1 - Hy, 2)
    ll = latlon_metrics_1d(
        j_cont, southernmost_latitude=southernmost_latitude, Ny=Ny, radius=radius,
        dlam_deg=dlam)
    for name in metrics:
        if name.startswith("dy"):
            metrics[name][: Hy + 1, :] = ll["dy"]
        else:
            metrics[name][: Hy + 1, :] = ll[name][:, None]

    # z coordinate: a (z_bottom, z_top) tuple or Nz+1 interfaces
    z_seq = np.asarray(z, np.float64).ravel()
    if z_seq.size == 2:
        z0, z1 = float(z_seq[0]), float(z_seq[1])
        z_f = np.linspace(z0, z1, Nz + 1)
        z_interfaces = None
    elif z_seq.size == Nz + 1:
        if not np.all(np.diff(z_seq) > 0):
            raise ValueError("z interfaces must be strictly increasing (bottom to top)")
        z_f = z_seq
        z0, z1 = float(z_f[0]), float(z_f[-1])
        z_interfaces = tuple(float(v) for v in z_f)
    else:
        raise ValueError(
            f"z must be a (z_bottom, z_top) tuple or Nz+1={Nz + 1} interfaces, "
            f"got {z_seq.size} values")
    z_c = 0.5 * (z_f[:-1] + z_f[1:])

    out = dict(coords)
    out.update(metrics)
    out.update({"z_f": z_f, "z_c": z_c})
    out["meta"] = dict(
        Nx=Nx, Ny=Ny, Nz=Nz, Hx=Hx, Hy=Hy, Hz=Hz,
        radius=float(radius), Lz=float(z1 - z0), dz=float((z1 - z0) / Nz),
        southernmost_latitude=float(southernmost_latitude),
        north_poles_latitude=float(north_poles_latitude),
        first_pole_longitude=float(first_pole_longitude),
        z_bounds=(z0, z1),
        z_interfaces=z_interfaces,
    )
    return out


ARRAY_FIELDS = (
    "lam_cc", "lam_fc", "lam_cf", "lam_ff",
    "phi_cc", "phi_fc", "phi_cf", "phi_ff",
    "dx_cc", "dx_fc", "dx_cf", "dx_ff",
    "dy_cc", "dy_fc", "dy_cf", "dy_ff",
    "az_cc", "az_fc", "az_cf", "az_ff",
    "z_f", "z_c",
)

META_FIELDS = (
    "Nx", "Ny", "Nz", "Hx", "Hy", "Hz", "radius", "Lz", "dz",
    "southernmost_latitude", "north_poles_latitude", "first_pole_longitude",
    "z_bounds", "z_interfaces",
)


class TripolarGrid(nn.Module):
    """Tripolar coordinates (degrees) and metrics (m, m²) as registered buffers.

    2-D buffers are halo-inclusive ``(Ny+2Hy, Nx+2Hx)`` with layout [y, x]; sizes,
    halos and the conformal-mapping parameters are plain attributes. Build one with
    ``TripolarGrid.make``; the constructor takes arrays already cast and placed."""

    def __init__(self, arrays, meta):
        super().__init__()
        for name in ARRAY_FIELDS:
            self.register_buffer(name, arrays[name])
        for name in META_FIELDS:
            setattr(self, name, meta[name])

    @staticmethod
    def make(
        size,
        southernmost_latitude=-80.0,
        halo=(4, 4, 4),
        radius=geo.R_EARTH,
        z=(0.0, 1.0),
        north_poles_latitude=55.0,
        first_pole_longitude=70.0,
        dtype=torch.float32,
        *,
        device="cuda",
        phi_spacing=None,
        backend="numpy",
    ):
        """Generate the grid in float64 on the host and place it on ``device`` (the
        card unless the caller asks for the CPU) in ``dtype``. The signature follows the reference constructor
        (``src/tripolar_grid.jl:59-66``); ``dtype`` is its ``FT``."""
        raw = build_tripolar_arrays(
            size, southernmost_latitude=southernmost_latitude, halo=halo,
            radius=radius, z=z, north_poles_latitude=north_poles_latitude,
            first_pole_longitude=first_pole_longitude, backend=backend,
            phi_spacing=phi_spacing)
        meta = raw.pop("meta")
        arrays = {k: torch.as_tensor(v).to(device=device, dtype=dtype)
                  for k, v in raw.items()}
        return TripolarGrid(arrays, meta)

    @property
    def size(self):
        return (self.Nx, self.Ny, self.Nz)

    @property
    def halo(self):
        return (self.Hx, self.Hy, self.Hz)

    @property
    def shape2d(self):
        """Halo-inclusive (y, x) shape of 2-D fields on this grid."""
        return (self.Ny + 2 * self.Hy, self.Nx + 2 * self.Hx)

    @property
    def interior2d(self):
        """(y, x) slices selecting the interior of a halo-inclusive 2-D field."""
        return (slice(self.Hy, self.Hy + self.Ny), slice(self.Hx, self.Hx + self.Nx))

    def interior(self, A):
        jy, jx = self.interior2d
        return A[..., jy, jx]

    @property
    def dtype(self):
        return self.lam_cc.dtype

    @property
    def device(self):
        return self.lam_cc.device


def with_halo(grid: TripolarGrid, new_halo) -> TripolarGrid:
    """Regenerate the grid with another halo from its conformal-mapping parameters
    (``src/with_halo.jl:5-23``): the split-explicit free surface widens the halo so
    the barotropic substep loop needs no exchange."""
    return TripolarGrid.make(
        grid.size,
        southernmost_latitude=grid.southernmost_latitude,
        halo=tuple(new_halo),
        radius=grid.radius,
        z=grid.z_interfaces if grid.z_interfaces is not None else grid.z_bounds,
        north_poles_latitude=grid.north_poles_latitude,
        first_pole_longitude=grid.first_pole_longitude,
        dtype=grid.dtype,
        device=grid.device,
    )
