"""The plain reference of the benchmark's model: the single-layer Bickley jet, built and
stepped in plain PyTorch on any device and dtype.

A frozen, trimmed restatement of the port's plain paths (``models/hydrostatic.py``,
``models/split_explicit.py``, ``grids/immersed.py`` and the plain versions in
``kernels/``), cut to the options the configuration uses: WENO-5 vector-invariant
momentum, a flux-form WENO-5 tracer, quasi-AB2 (χ = 0.1, forward Euler on the first
step), and the split-explicit free surface: SM05-averaged forward-backward substeps in
halos widened to the number of weights + 1, so the subcycle needs no fill.

A model is a dict of tensors and options (``build``); a state is a dict of tensors
with the port's field names. The grid is worked out again here (``grid.tripolar``),
and the inputs (bottom, initial fields) are functions of (λ°, φ°) that the model
samples at coordinates stored in ``sample_dtype``, as the program samples them at its
grid's coordinates in the configuration's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fills, grid as rgrid
from .ops import X, Y, dxc, dxf, dyc, dyf, inv, ixc, ixf, iyc, iyf, weno5_centers, weno5_faces

G_EARTH = 9.80665
OMEGA = 7.292115e-5
CHI = 0.1


def sm05_weights(substeps):
    """(Δτ as a share of Δt, the normalized weights) of the Shchepetkin and McWilliams
    (2005) averaging kernel (p = 2, q = 4, r = 0.18927), cut after its last positive
    value."""
    dtau = 2.0 / substeps
    tau = dtau * np.arange(1, substeps + 1)
    tau0 = 4.0 * 8.0 / (3.0 * 7.0)
    x = tau / tau0
    w = x ** 2 * (1 - x ** 4) - 0.18927 * x
    last = np.nonzero(w > 0)[0][-1]
    w = np.clip(w[:last + 1], 0.0, None)
    return dtau, w / w.sum()


def _rounded(a, dtype):
    """``a`` (float64 numpy) rounded to ``dtype`` and back."""
    return torch.as_tensor(a).to(dtype).to(torch.float64).numpy()


def build(cfg, funcs, *, dtype=torch.float64, device="cpu", sample_dtype=torch.float32):
    """The model of configuration ``cfg`` (the configuration file's dict: ``nx``,
    ``ny``, ``halo``, the poles, ``substeps`` and ``physics``) with ``funcs`` (its
    ``bottom``) in ``dtype`` on ``device``."""
    Nx, Ny, H = cfg["nx"], cfg["ny"], cfg["halo"]
    phys = cfg["physics"]
    dtau, weights = sm05_weights(cfg["substeps"])
    He = max(len(weights) + 1, H)
    poles = dict(north_poles_latitude=cfg["north_poles_latitude"],
                 first_pole_longitude=cfg["first_pole_longitude"])
    ge64 = rgrid.tripolar(Nx, Ny, He, **poles)
    d = He - H
    g64 = {k: a[d:d + Ny + 2 * H, d:d + Nx + 2 * H] for k, a in ge64.items()}
    z0, z1 = 0.0, 1.0

    def t(a):
        return torch.as_tensor(np.array(a, np.float64)).to(device=device, dtype=dtype)

    def at(g, name):
        return _rounded(g[name], sample_dtype)

    def immersed(g, Hh):
        lam, phi = (at(g, n)[Hh:Hh + Ny, Hh:Hh + Nx] for n in ("lam_cc", "phi_cc"))
        bot = np.full(g["lam_cc"].shape, z1)
        bot[Hh:Hh + Ny, Hh:Hh + Nx] = np.broadcast_to(funcs["bottom"](lam, phi), (Ny, Nx))
        bot = fills.fill(bot, "cc", 1, Nx, Ny, Hh, Hh)
        h_c = np.clip(z1 - np.maximum(bot, z0), 0.0, None)
        h_u = np.minimum(h_c, np.roll(h_c, 1, axis=-1))
        h_v = np.minimum(h_c, np.roll(h_c, 1, axis=-2))
        return h_c, h_u, h_v

    h_c, h_u, h_v = immersed(g64, H)
    _, h_ue, h_ve = immersed(ge64, He)
    g = {k: t(a) for k, a in g64.items()}
    ge = {k: t(ge64[k]) for k in ("dy_fc", "dx_cf", "az_cc", "dx_fc", "dy_cf")}
    m = dict(Nx=Nx, Ny=Ny, H=H, He=He, dtype=dtype, device=device, g=g, ge=ge, phys=phys,
             weights=t(weights), dtau=float(dtau), g_acc=G_EARTH,
             sample_dtype=sample_dtype, sample={k: at(g64, k) for k in rgrid.COORDS})
    m["mask_c"], m["mask_u"], m["mask_v"] = (t(h > 0) for h in (h_c, h_u, h_v))
    m["h_u"], m["h_v"], m["h_c"] = t(h_u), t(h_v), t(h_c)
    m["inv_h_u"], m["inv_h_v"] = inv(m["h_u"]), inv(m["h_v"])
    m["gh_u_e"], m["gh_v_e"] = G_EARTH * t(h_ue), G_EARTH * t(h_ve)
    m["mask_u_e"], m["mask_v_e"] = t(h_ue > 0), t(h_ve > 0)
    m["f_ff"] = (2.0 * OMEGA * torch.sin(torch.deg2rad(g["phi_ff"])) if phys.get("coriolis")
                 else torch.zeros_like(g["phi_ff"]))
    return m


def _sample(m, fn, loc):
    """``fn`` at the interior points of ``loc`` (halos 0), float64 numpy."""
    H, Ny, Nx = m["H"], m["Ny"], m["Nx"]
    lam, phi = m["sample"]["lam_" + loc], m["sample"]["phi_" + loc]
    out = np.zeros(lam.shape)
    if fn is not None:
        out[H:H + Ny, H:H + Nx] = np.broadcast_to(fn(lam, phi), lam.shape)[H:H + Ny, H:H + Nx]
    return out


def _embed(m, A):
    d = m["He"] - m["H"]
    return torch.nn.functional.pad(A, (d, d, d, d))


def _crop(m, A):
    d, H = m["He"] - m["H"], m["H"]
    return A[..., d:d + m["Ny"] + 2 * H, d:d + m["Nx"] + 2 * H]


def initial_state(m, init):
    """The state from ``init``: {"u", "v", "eta", "c"}, each a function of (λ°, φ°)."""
    dt, dev = m["dtype"], m["device"]

    def t(a):
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    eta = t(_sample(m, init.get("eta"), "cc")) * m["mask_c"]
    u = t(_sample(m, init.get("u"), "fc")) * m["mask_u"]
    v = t(_sample(m, init.get("v"), "cf")) * m["mask_v"]
    c = t(_sample(m, init.get("c"), "cc")) * m["mask_c"]
    U, V = m["h_u"] * u, m["h_v"] * v
    return dict(u=u, v=v, eta=_embed(m, eta), U=_embed(m, U), V=_embed(m, V), c=c,
                Gu=torch.zeros_like(u), Gv=torch.zeros_like(v), Gc=torch.zeros_like(c),
                t=torch.zeros((), dtype=dt, device=dev),
                iteration=torch.zeros((), dtype=torch.int64, device=dev))


# ------------------------------------------------------------------------------------
# The stages
# ------------------------------------------------------------------------------------

def fill_state(m, s):
    """The prognostic fields with their halos filled: (u, v, c, eta, U, V)."""
    base, ext = (m["Nx"], m["Ny"], m["H"], m["H"]), (m["Nx"], m["Ny"], m["He"], m["He"])
    return (fills.fill(s["u"], "fc", -1, *base), fills.fill(s["v"], "cf", -1, *base),
            fills.fill(s["c"], "cc", 1, *base), fills.fill(s["eta"], "cc", 1, *ext),
            fills.fill(s["U"], "fc", -1, *ext), fills.fill(s["V"], "cf", -1, *ext))


def momentum(m, u, v):
    """(Gu, Gv): the vector-invariant WENO-5 momentum tendency of halo-filled u and v,
    masked."""
    g = m["g"]
    zeta = (dxf(g["dy_cf"] * v) - dyf(g["dx_fc"] * u)) * inv(g["az_ff"])
    q = zeta + m["f_ff"]
    v_hat = ixf(iyc(g["dx_cf"] * v)) * inv(g["dx_fc"])
    u_hat = iyf(ixc(g["dy_fc"] * u)) * inv(g["dy_cf"])
    ke = 0.5 * (ixc(u * u) + iyc(v * v))
    Gu = weno5_centers(q, v_hat, Y) * v_hat - dxf(ke) * inv(g["dx_fc"])
    Gv = -weno5_centers(q, u_hat, X) * u_hat - dyf(ke) * inv(g["dy_cf"])
    return Gu * m["mask_u"], Gv * m["mask_v"]


def tracer(m, c, u, v):
    """Gc: the flux-form WENO-5 tendency of halo-filled ``c``."""
    g = m["g"]
    fx = u * m["h_u"] * g["dy_fc"] * weno5_faces(c, u, X)
    fy = v * m["h_v"] * g["dx_cf"] * weno5_faces(c, v, Y)
    return -(dxc(fx) + dyc(fy)) * m["mask_c"] * inv(g["az_cc"] * m["h_c"])


def barotropic(m, eta, U, V, GU, GV, dt):
    """The SM05-averaged averages (η, U, V) of the forward-backward substeps of Δτ =
    share·Δt on the widened grid, without a fill inside the loop."""
    ge = m["ge"]
    dtau = m["dtau"] * dt
    inv_az, inv_dx, inv_dy = inv(ge["az_cc"]), inv(ge["dx_fc"]), inv(ge["dy_cf"])
    eta_a, U_a, V_a = (torch.zeros_like(a) for a in (eta, U, V))
    for w in m["weights"]:
        eta = eta - dtau * (dxc(ge["dy_fc"] * U) + dyc(ge["dx_cf"] * V)) * inv_az
        U = (U - dtau * (m["gh_u_e"] * dxf(eta) * inv_dx - GU)) * m["mask_u_e"]
        V = (V - dtau * (m["gh_v_e"] * dyf(eta) * inv_dy - GV)) * m["mask_v_e"]
        eta_a, U_a, V_a = eta_a + w * eta, U_a + w * U, V_a + w * V
    return eta_a, U_a, V_a


def step(m, s, dt):
    """One time step of state ``s`` at Δt = ``dt`` (a number): the new state."""
    dt = torch.tensor(float(dt), dtype=m["dtype"], device=m["device"])
    u, v, c, eta, U, V = fill_state(m, s)
    first = int(s["iteration"]) == 0
    w1, w2 = (1.0, 0.0) if first else (1.5 + CHI, 0.5 + CHI)
    ext = (m["Nx"], m["Ny"], m["He"], m["He"])
    Gu, Gv = momentum(m, u, v)
    Gc = tracer(m, c, u, v)
    GU = fills.fill(_embed(m, m["h_u"] * (w1 * Gu - w2 * s["Gu"])), "fc", -1, *ext)
    GV = fills.fill(_embed(m, m["h_v"] * (w1 * Gv - w2 * s["Gv"])), "cf", -1, *ext)
    eta_a, U_a, V_a = barotropic(m, eta, U, V, GU, GV, dt)
    return dict(s, eta=eta_a, U=U_a, V=V_a, Gu=Gu, Gv=Gv, Gc=Gc, t=s["t"] + dt,
                iteration=s["iteration"] + 1,
                c=(s["c"] + dt * (w1 * Gc - w2 * s["Gc"])) * m["mask_c"],
                u=_crop(m, U_a) * m["inv_h_u"] * m["mask_u"],
                v=_crop(m, V_a) * m["inv_h_v"] * m["mask_v"])


def run(m, s, dt, n):
    """``n`` steps at ``dt``."""
    for _ in range(int(n)):
        s = step(m, s, dt)
    return s




def vertical_vorticity(m, s):
    """ζ at FF of the halo-filled u and v of state ``s`` (the diagnostic a run may
    write)."""
    g, base = m["g"], (m["Nx"], m["Ny"], m["H"], m["H"])
    u, v = fills.fill(s["u"], "fc", -1, *base), fills.fill(s["v"], "cf", -1, *base)
    return (dxf(g["dy_cf"] * v) - dyf(g["dx_fc"] * u)) * inv(g["az_ff"])


__all__ = ["build", "initial_state", "step", "run", "fill_state", "momentum", "tracer",
           "barotropic", "vertical_vorticity", "sm05_weights"]
