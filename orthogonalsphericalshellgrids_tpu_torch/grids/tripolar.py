"""Tripolar grid construction (Murray 1996 cofocal ellipse/hyperbola mapping).

Counterpart: ``orthogonalsphericalshellgrids_tpu/grids/tripolar.py``
(``_murray_mapping``, ``newton_phi_nodes``, ``build_tripolar_arrays``,
``TripolarGrid.make``, ``cartesian_nodes``, ``with_halo``); the reference constructor
is ``src/tripolar_grid.jl:59-333``.

Generation runs on the host in float64, exactly as in the JAX package: numpy, or the
native C++/OpenMP kernels (``grids/native.py``) for the mapping and the metrics,
which ``backend="auto"`` takes at Nx·Ny >= 512·256 when they build. ``phi_spacing``
places the latitude rows under a spacing law by a Newton solve in torch float64
(``newton_phi_nodes``). ``TripolarGrid.make`` then casts every array to the model
dtype on the requested device, where it is a registered buffer of an ``nn.Module``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import zipper
from ..ops.location import CC, CF, FC, FF
from . import geometry as geo
from . import native
from .latlon import latlon_metrics_1d

__all__ = ["TripolarGrid", "build_tripolar_arrays", "newton_phi_nodes",
           "cartesian_nodes", "with_halo", "BACKENDS"]

BACKENDS = ("auto", "numpy", "native")
# "auto" takes the native kernels from this many cells (the JAX package's rule)
NATIVE_FROM = 512 * 256


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


def newton_phi_nodes(southernmost_latitude, Ny, spacing, tol=1e-12, max_iter=50):
    """Ny latitude rows from ``southernmost_latitude`` to 90° under a spacing law.

    The rows follow the midpoint march φ_{j+1} = φ_j + s·f(φ_j + s·f(φ_j)/2), and
    the scale s that lands φ_{Ny-1} = 90 exactly is found by Newton iteration, the
    derivative dφ_end/ds taken by ``torch.autograd`` through the march (the JAX
    package takes ``jax.grad`` through a ``lax.scan``), in float64: at most
    ``max_iter`` steps, until |φ_end - 90| <= ``tol``, from the scale of the mean of
    65 law samples over the range (exact for a uniform law).

    ``spacing``: a positive callable f(φ° tensor) -> relative spacing weight, on
    float64 torch tensors. Returns float64 numpy rows, the first the southernmost
    and the last pinned to 90; raises ``ValueError`` when the solve does not give
    a monotone distribution (a law that is not positive)."""
    lo, hi = float(southernmost_latitude), 90.0
    f64 = torch.float64

    def march(s, rows=None):
        phi = torch.tensor(lo, dtype=f64)
        for _ in range(Ny - 1):
            phi = phi + s * spacing(phi + 0.5 * s * spacing(phi))
            if rows is not None:
                rows.append(phi)
        return phi

    def g_and_dg(s):
        s = s.detach().requires_grad_(True)
        end = march(s)
        (dg,) = torch.autograd.grad(end, s, allow_unused=True)
        return float(end.detach()) - hi, (torch.zeros_like(s) if dg is None else dg).detach()

    x = torch.linspace(lo, hi, 65, dtype=f64)
    w = torch.mean(torch.broadcast_to(torch.as_tensor(spacing(x), dtype=f64), x.shape))
    s = (hi - lo) / ((Ny - 1) * w)
    g, dg = g_and_dg(s)
    it = 0
    while abs(g) > tol and it < max_iter:
        s = s - g / dg
        g, dg = g_and_dg(s)
        it += 1
    rows = []
    with torch.no_grad():
        march(s, rows)
    phis = np.concatenate([[lo], torch.stack(rows).numpy()]) if rows else np.array([lo])
    # a degenerate law gives NaN rows, which must land here too
    if not (abs(phis[-1] - hi) <= 1e-8 and np.all(np.diff(phis) > 0)):
        raise ValueError(
            "phi_spacing Newton solve did not converge to a monotone latitude "
            f"distribution (endpoint {phis[-1]!r}); is the spacing law positive?")
    phis[-1] = hi  # the pole row exactly (the Newton residual is <= tol)
    return phis


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
    backend="auto",
    phi_spacing=None,
):
    """All tripolar coordinate/metric arrays in float64 numpy: a dict of
    halo-inclusive (Ny+2Hy, Nx+2Hx) arrays for the 8 coordinates and 12 metrics, the
    1-D z data, and ``meta``. Keyword names and defaults follow the reference
    constructor (``src/tripolar_grid.jl:59-66``).

    ``backend``: "numpy", "native" (the C++ kernels of ``grids/native.py``; raises
    when they cannot be built) or "auto" (native at Nx·Ny >= 512·256 when it builds,
    else numpy). ``phi_spacing``: None for uniform rows, or a spacing law on torch
    float64 tensors (``newton_phi_nodes``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown grid-generation backend {backend!r}; options: "
                         f"{BACKENDS}")
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
    if phi_spacing is None:
        phiC1 = np.linspace(southernmost_latitude, 90.0, Ny)
        dphi = phiC1[1] - phiC1[0]
        phiF1 = phiC1 - dphi / 2.0
    else:
        # faces midway between consecutive centers (the uniform rule for a constant
        # law), the south face extrapolated
        phiC1 = newton_phi_nodes(southernmost_latitude, Ny, phi_spacing)
        phiF1 = np.empty_like(phiC1)
        phiF1[1:] = 0.5 * (phiC1[1:] + phiC1[:-1])
        phiF1[0] = phiC1[0] - 0.5 * (phiC1[1] - phiC1[0])

    if backend == "native" and not native.available():
        raise RuntimeError(f"native grid-generation backend requested but unavailable: "
                           f"{native.build_error()}")
    use_native = backend == "native" or (
        backend == "auto" and Nx * Ny >= NATIVE_FROM and native.available())

    def mapper(l1, p1):
        if use_native:
            return native.murray_coords(l1, p1, Nx, focal_distance, first_pole_longitude)
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

    if use_native:
        metrics = native.metric_arcs(coords, Nx, Ny, Hx, Hy, radius)
    else:
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
        phi_spacing=phi_spacing,
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
    "z_bounds", "phi_spacing", "z_interfaces",
)


class TripolarGrid(nn.Module):
    """Tripolar coordinates (degrees) and metrics (m, m²) as registered buffers.

    2-D buffers are halo-inclusive ``(Ny+2Hy, Nx+2Hx)`` with layout [y, x]; sizes,
    halos, the conformal-mapping parameters and the latitude-spacing law
    (``phi_spacing``, None for uniform rows) are plain attributes. Build one with
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
        backend="auto",
    ):
        """Generate the grid in float64 on the host and place it on ``device`` (the
        card unless the caller asks for the CPU) in ``dtype``. The signature follows
        the reference constructor (``src/tripolar_grid.jl:59-66``); ``dtype`` is its
        ``FT``; ``phi_spacing`` and ``backend`` as in ``build_tripolar_arrays``."""
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

    @property
    def conformal_mapping(self):
        """The reference's ``Tripolar`` mapping parameters (``src/tripolar_grid.jl:
        6-10``)."""
        return dict(north_poles_latitude=self.north_poles_latitude,
                    first_pole_longitude=self.first_pole_longitude,
                    southernmost_latitude=self.southernmost_latitude)


def cartesian_nodes(grid: TripolarGrid, loc="ff"):
    """Unit-sphere cartesian (x, y, z) interior node arrays (numpy, the grid's
    dtype) at the staggered location ``loc`` ("ff", "fc", "cf" or "cc"): the node
    half of the reference's ``get_cartesian_nodes_and_vertices`` (used by
    ``examples/visualize_tripolar_grid.jl:41-45``)."""
    lam = grid.interior(getattr(grid, f"lam_{loc}")).cpu().numpy()
    phi = grid.interior(getattr(grid, f"phi_{loc}")).cpu().numpy()
    return geo.lat_lon_to_cartesian(phi, lam, 1.0, xp=np)


def with_halo(grid: TripolarGrid, new_halo) -> TripolarGrid:
    """Regenerate the grid with another halo from its conformal-mapping parameters
    and its latitude-spacing law (``src/with_halo.jl:5-23``): the split-explicit
    free surface widens the halo so the barotropic substep loop needs no
    exchange."""
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
        phi_spacing=grid.phi_spacing,
    )
