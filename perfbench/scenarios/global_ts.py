"""A global stratified ocean with T and S on the tripolar grid: the land of
``examples/wind_driven_ts_gyre_torch.py:build`` without its barrier (the two north
pole masks and Antarctica), an analytic bottom of fixed modes, the gyre example's
zonal wind stress, a stratified T(z) and S(z), and seeded perturbations of u, v, η, T
and S of the amplitudes the configuration gives.

- ``z_faces``: the configuration's layer faces (``vertical``), surface 0, ascending:
  thicknesses dz_k = top + A·(k / (Nz − 1))^p that sum to the depth.
- Bottom: −D(λ, φ), D between ``depth_min`` and the full depth from fixed modes,
  shoaling to 1 m over ``shelf_deg`` degrees towards every coast, so that the wet-layer
  counts run from 1 to Nz.
- Near the poles λ turns a full circle within a few cells (the tripolar grid's
  ocean covers the geographic North Pole), so every part that varies with λ is
  tapered to none over the last ``POLAR_DEG`` degrees (``polar``): without it the
  bottom's modes put cliffs of 3 km between neighbouring cells north of 85°, where a
  run at Δt = 300 s turned to NaN within a simulated day.
- Perturbations: each of u, v, T and S a smooth part (the fixed modes of
  ``lib/scenario.perturbation`` in seeded phases, decaying as e^{z/500}) and a part
  at the scale of one layer ((−1)^k on the upper ``layer_scale_layers`` layers, over
  another seeded smooth plane); T and S each also a part at the scale of three grid
  cells in x and y (seeded phases) on the upper ``layer_scale_layers`` layers. S's
  layer-scale and grid-scale parts are T's times α/β, so that they leave the buoyancy
  of the linear equation of state unchanged (spice), and the grid-scale part drives no
  flow while advection and κ_h work on it.

The parts that no seed changes are kept in ``kept``.
"""

import numpy as np

from perfbench.lib.scenario import memo, perturbation

SOUTH = -80.0  # the grid's southernmost latitude (the generator's default)
E_FOLD_M = 500.0  # the smooth perturbations' depth scale
POLAR_DEG = 10.0  # the λ-dependent parts taper to none over the last degrees to a pole


def polar(phi):
    """1 up to ``POLAR_DEG`` degrees from a pole, falling linearly to 0 at it."""
    return np.clip((90.0 - np.abs(phi)) / POLAR_DEG, 0.0, 1.0)


def tapered(rng, amplitude, kept):
    """``lib/scenario.perturbation`` times ``polar``."""
    fn = perturbation(rng, amplitude, kept)
    return lambda lam, phi: polar(phi) * fn(lam, phi)


def z_faces(cfg):
    """The Nz + 1 layer faces [m], ascending from −depth to 0 (float64)."""
    vert, nz = cfg["vertical"], cfg["nz"]
    shape = (np.arange(nz, dtype=np.float64) / max(nz - 1, 1)) ** vert["stretch_power"]
    top, depth = vert["top_cell_m"], vert["depth_m"]
    dz = top + (depth - nz * top) * shape / shape.sum()  # surface first
    faces = -np.concatenate([[0.0], np.cumsum(dz)])
    faces[-1] = -depth
    return faces[::-1].copy()


def centres(faces):
    """Layer-centre depths, surface first."""
    zf = np.asarray(faces, np.float64)[::-1]
    return 0.5 * (zf[:-1] + zf[1:])


def inputs(cfg, rng, kept):
    lam_p, phi_p = cfg["first_pole_longitude"], cfg["north_poles_latitude"]
    faces = z_faces(cfg)
    zc = centres(faces)
    bot = cfg["bottom"]
    depth = cfg["vertical"]["depth_m"]
    amp = cfg["perturbation"]
    phys = cfg["physics"]
    spice = phys["thermal_expansion"] / phys["haline_contraction"]
    n_layer = min(amp["layer_scale_layers"], cfg["nz"])

    def pole_distance(lam, phi, lam0):
        dlam = np.abs((lam - lam0 + 180.0) % 360.0 - 180.0)
        return np.maximum(dlam, np.abs(phi_p - phi))

    def coast(lam, phi):
        """Degrees to the nearest land (the pole boxes' edges, Antarctica's)."""
        half = bot["pole_box_deg"]
        return np.minimum.reduce([pole_distance(lam, phi, lam_p) - half,
                                  pole_distance(lam, phi, (lam_p + 180.0) % 360.0) - half,
                                  phi - bot["antarctic_latitude"]])

    def bottom(lam, phi):
        d = coast(lam, phi)
        lr, pr = np.deg2rad(lam), np.deg2rad(phi)
        modes = 0.55 + polar(phi) * (0.3 * np.cos(2 * lr) * np.cos(3 * pr) + 0.2 * np.sin(
            5 * lr + 1.0) * np.cos(4 * pr) + 0.15 * np.cos(9 * lr + 2.0) * np.sin(7 * pr + 0.5))
        deep = bot["depth_min"] + (depth - bot["depth_min"]) * np.clip(modes, 0.0, 1.0)
        shelf = 1.0 + (depth - 1.0) * np.clip(d / bot["shelf_deg"], 0.0, 1.0)
        return np.where(d <= 0.0, 1.0, -np.minimum(deep, shelf))

    def wind(lam, phi):  # the gyre example's: easterly trades, westerlies poleward of 30°
        taux = -phys["wind_tau0"] * np.cos(np.deg2rad(phi) * 3.0) * np.cos(np.deg2rad(phi))
        return taux, np.zeros_like(taux)

    def layer_sign(z):
        k = int(np.argmin(np.abs(zc - z)))
        return float((-1) ** k) if k < n_layer else 0.0

    def upper(z):
        return 1.0 if int(np.argmin(np.abs(zc - z))) < n_layer else 0.0

    ax, ay = rng.uniform(0.0, 2.0 * np.pi, size=2)
    dphi = (90.0 - SOUTH) / (cfg["ny"] - 1)

    def grid_scale(lam, phi):  # a period of three cells in x and in y
        return polar(phi) * (np.cos(cfg["nx"] / 3.0 * np.deg2rad(lam) + ax)
                * np.cos(2.0 * np.pi / 3.0 * (phi - SOUTH) / dphi + ay))

    def part(a):
        smooth, layer = tapered(rng, a, kept), tapered(rng, a, kept)

        def fn(lam, phi, z):
            out = np.exp(z / E_FOLD_M) * smooth(lam, phi)
            s = layer_sign(z)
            return out + s * layer(lam, phi) if s else out

        return fn

    du, dv = part(amp["u"]), part(amp["v"])
    deta = tapered(rng, amp["eta"], kept)
    dT_smooth = tapered(rng, amp["T"], kept)
    dT_layer = tapered(rng, amp["T_layer"], kept)
    dS_smooth = tapered(rng, amp["S"], kept)

    def T0(lam, phi, z):
        return 2.0 + 26.0 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 600.0)

    def S0(lam, phi, z):
        return 34.5 + 1.0 * np.cos(np.deg2rad(phi)) ** 2 * np.exp(z / 800.0)

    def spiced(lam, phi, z):
        """The T part that S carries times α/β: layer scale and grid scale."""
        s = layer_sign(z)
        out = s * dT_layer(lam, phi) if s else 0.0
        if upper(z):
            out = out + amp["T_grid"] * memo(kept, f"grid_scale {ax!r} {ay!r}",
                                             lambda: grid_scale(lam, phi), lam, phi)
        return out

    def T(lam, phi, z):
        return T0(lam, phi, z) + np.exp(z / E_FOLD_M) * dT_smooth(lam, phi) + spiced(lam, phi, z)

    def S(lam, phi, z):
        return (S0(lam, phi, z) + np.exp(z / E_FOLD_M) * dS_smooth(lam, phi)
                + spice * spiced(lam, phi, z))

    return dict(bottom=bottom, wind=wind, z_faces=faces,
                init=dict(u=du, v=dv, eta=deta, T=T, S=S))
