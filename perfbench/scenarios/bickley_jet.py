"""The Bickley jet of ``examples/bickley_jet.jl:27-73`` (as ``examples/
bickley_jet_torch.py:build`` sets it up): land over the two north poles and south of
78° S, the jet's u and v with their wave, the tracer's bands, and seeded perturbations
of u, v and η of the amplitudes the configuration gives. The parts that no seed
changes are kept in ``kept``, which an ensemble's members share."""

import numpy as np

from perfbench.lib.scenario import memo, perturbation


def inputs(cfg, rng, kept):
    lam_p, phi_p = cfg["first_pole_longitude"], cfg["north_poles_latitude"]

    def bottom(lam, phi):
        land = (((np.abs(lam - lam_p) < 5) & (np.abs(phi_p - phi) < 5))
                | ((np.abs(lam - (lam_p + 180.0) % 360.0) < 5) & (np.abs(phi_p - phi) < 5))
                | (phi < -78))
        return np.where(land, 1.0, 0.0)

    eps, ell, k = 0.1, 0.5, 2.5

    def psit(x, y):
        return np.exp(-((y + ell / 10) ** 2) / (2 * ell ** 2)) * np.cos(k * x) * np.cos(k * y)

    amp = cfg["perturbation"]
    du, dv, deta = (perturbation(rng, amp[n], kept) for n in ("u", "v", "eta"))

    def jet_u(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 8
        return 1.0 / np.cosh(y) ** 2 + eps * psit(x, y) * (k * np.tan(k * y) + y / ell ** 2)

    def jet_v(lam, phi):
        x, y = np.deg2rad(lam) * 2, np.deg2rad(phi) * 4
        return -eps * psit(x, y) * k * np.tan(k * x)

    def u(lam, phi):
        return memo(kept, "jet_u", lambda: jet_u(lam, phi), lam, phi) + du(lam, phi)

    def v(lam, phi):
        return memo(kept, "jet_v", lambda: jet_v(lam, phi), lam, phi) + dv(lam, phi)

    def c(lam, phi):
        return memo(kept, "jet_c", lambda: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0),
                    lam, phi)

    return dict(bottom=bottom, init=dict(u=u, v=v, c=c, eta=deta))
