"""The inputs of a configuration, drawn from the seed by the scenario that the
configuration names: ``scenarios/<scenario>.py``, whose ``inputs(cfg, rng)`` returns
the bottom and the initial fields as functions of (λ°, φ°), each field the scenario's
example field plus a seeded perturbation (``perturbation``).

The program and the reference both receive these same functions and sample them at
their own grid points; nothing else of one side reaches the other. Every seed gives
perturbations of the same modes and amplitudes in other phases, so every seed gives
the same work. A member of an ensemble draws its own phases from the seed and its
index.

An ensemble samples the same functions at the same points once a member, so the
parts that do not depend on the seed are kept in a dict that its members share
(``memo``).
"""

from __future__ import annotations

import numpy as np

from . import cells

MODES = ((3, 2), (5, 4), (7, 6), (11, 8))  # (zonal, meridional) wave numbers


def memo(kept, name, make, lam, phi):
    """``make()``, kept in the dict ``kept`` under ``name`` and the points (λ, φ) it is
    sampled at (their shape and every 101st of their values)."""
    key = (name,) + tuple((a.shape, np.ascontiguousarray(a).ravel()[::101].tobytes())
                          for a in (np.asarray(lam), np.asarray(phi)))
    if key not in kept:
        kept[key] = make()
    return kept[key]


def rng_of(seed, member=None):
    """The generator of ``--seed`` (any whole number, also above 32 bits), and of
    member ``member`` of an ensemble."""
    key = int(seed) % 2 ** 64
    return np.random.default_rng(key if member is None else [key, int(member)])


def perturbation(rng, amplitude, kept):
    """amplitude · Σ_k cos(m_k λ + α_k) cos(n_k φ + β_k) / k, normalized by Σ 1/k, with
    seeded phases; its basis is kept in ``kept`` (``memo``)."""
    phases = rng.uniform(0.0, 2.0 * np.pi, size=(len(MODES), 2))
    norm = sum(1.0 / (k + 1) for k in range(len(MODES)))

    def basis(lam, phi):  # cos(mλ) cos(nφ), cos(mλ) sin(nφ), ... of each mode, / k
        lr, pr = np.deg2rad(lam), np.deg2rad(phi)
        out = []
        for k, (m, n) in enumerate(MODES):
            cl, sl, cp, sp = np.cos(m * lr), np.sin(m * lr), np.cos(n * pr), np.sin(n * pr)
            out += [cl * cp / (k + 1), cl * sp / (k + 1), sl * cp / (k + 1), sl * sp / (k + 1)]
        return np.stack(out).astype(np.float32)  # a float32 basis: half the bytes a member

    a, b = phases[:, 0], phases[:, 1]
    # cos(mλ + α) cos(nφ + β) expanded over the basis
    coef = amplitude / norm * np.stack([np.cos(a) * np.cos(b), -np.cos(a) * np.sin(b),
                                        -np.sin(a) * np.cos(b), np.sin(a) * np.sin(b)],
                                       axis=1).ravel().astype(np.float32)

    def fn(lam, phi):
        return np.tensordot(coef, memo(kept, "modes", lambda: basis(lam, phi), lam, phi), axes=1)

    return fn


def module(cfg):
    """The scenario file that ``cfg["scenario"]`` names (``scenarios/<scenario>.py``)."""
    return cells.load_module(cells.HERE / "scenarios" / f"{cfg['scenario']}.py")


def inputs(cfg, seed, member=None):
    """{"bottom", "init"} of configuration ``cfg`` for ``seed`` (and ``member``)."""
    return module(cfg).inputs(cfg, rng_of(seed, member), {})
