"""The plain reference of the layered model: a stack of Nz z-layers over a grid-fitted
bottom with T and S, stepped in plain PyTorch on any device and dtype.

Restated from the mathematics of the port's layered step (``models/layered.py``) and
cut to the options the configurations use, on the single-layer reference's grid,
fills, operators and barotropic subcycle (``grid``, ``fills``, ``ops``,
``model.barotropic``). Per layer k (k = 0 at the surface, thickness dz_k):

- masks: a cell is wet where its centre lies above the bottom (as the configuration's
  dtype holds it) in a wet column; a u (v) face where both cells beside it in x (y)
  are; the masks are kept as each column's count of wet layers;
- w at the top of each layer from continuity, summed up from the floor: w_k =
  −Σ_{j≥k} dz_j δ(Δ u)_j / Az (u and v masked, so dz_j u = dzu_j u);
- momentum: WENO-5 vector-invariant advection, the vertical advection
  −½ Σ_faces ½(w + w_{i−1}) δz u / dzc, the hydrostatic pressure gradient of the
  linear equation of state (b = g (α (T − T0) − β (S − S0)), p_k = −Σ_{j<k} dz_j b_j −
  ½ dz_k b_k), Coriolis in the vorticity, harmonic ν_h with the layer's masks,
  quadratic drag Cd/dz_k |u| u on the deepest wet layer, the wind stress τ/dz_0 on
  layer 0; explicit ν_v δz(δz u) with implicit vertical mixing off;
- tracers: WENO-5 flux form with the layer's thickness, harmonic κ_h, the centred
  vertical flux w ½(c_{k−1} + c_k); explicit κ_v with implicit mixing off;
- quasi-AB2 (χ = 0.1, forward Euler on the first step); the split-explicit subcycle
  driven by Σ_k dzu_k (w1 G − w2 G_old) on the widened grid (``model.barotropic``);
- with implicit vertical mixing, backward Euler: (I − Δt κ δz δz) x = x* for each
  column (a tridiagonal solve, layers top down then bottom up) on the predicted
  velocities (ν_v, before the depth mean) and the updated tracers (κ_v);
- the depth-mean correction: u = (u* + U_a/H_u − Σ dzu u*/H_u)·mask_u, H_u = Σ dzu.

Departures from the port's code, none of them in the result: the masks come from
the wet-layer counts and are made a block of layers at a time; every horizontal
operator runs over a block of layers (``POINTS_PER_BLOCK`` points), so that at
1440 × 1080 × 75 in float64 the check, with the states it keeps, peaks near 40 GB
of the card; the vertical terms and the solves go a plane at a time; products and quotients of metrics are
formed in their own order.

A model is a dict of tensors and options (``build``); a state is a dict of tensors
with the port's field names (b and Gb are handed on unchanged). The inputs are the
scenario's: the layer faces ``z_faces``, the ``bottom`` and ``wind`` of (λ°, φ°),
and the initial fields, sampled at coordinates stored in ``sample_dtype``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fills, grid as rgrid
from .model import CHI, G_EARTH, OMEGA, _crop, _embed, _rounded, barotropic, sm05_weights
from .ops import X, Y, dxc, dxf, dyc, dyf, inv, ixc, ixf, iyc, iyf, sm
from .ops import weno5_centers, weno5_faces

POINTS_PER_BLOCK = 1 << 24  # the points of a block of layers that one pass works on


def layer_geometry(faces):
    """(zc, dz, dzc), surface first, float64: layer centres, thicknesses, and the
    spacings between neighbouring centres, from the ascending faces."""
    zf = np.asarray(faces, np.float64)[::-1]
    dz = zf[:-1] - zf[1:]
    return 0.5 * (zf[:-1] + zf[1:]), dz, 0.5 * (dz[:-1] + dz[1:])


def build(cfg, funcs, *, dtype=torch.float64, device="cpu", sample_dtype=torch.float32):
    """The model of configuration ``cfg`` (``nx``, ``ny``, ``nz``, ``halo``, the
    poles, ``substeps``, ``physics``) with the inputs ``funcs`` in ``dtype`` on
    ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False  # no product here runs in TF32
    torch.backends.cudnn.allow_tf32 = False
    Nx, Ny, H, nz = cfg["nx"], cfg["ny"], cfg["halo"], cfg["nz"]
    phys = cfg["physics"]
    dtau, weights = sm05_weights(cfg["substeps"])
    He = max(len(weights) + 1, H)
    ge64 = rgrid.tripolar(Nx, Ny, He, north_poles_latitude=cfg["north_poles_latitude"],
                          first_pole_longitude=cfg["first_pole_longitude"])
    d = He - H
    g64 = {k: a[d:d + Ny + 2 * H, d:d + Nx + 2 * H] for k, a in ge64.items()}
    faces = np.asarray(funcs["z_faces"], np.float64)
    z0, z1 = faces[0], faces[-1]
    zc, dz, dzc = layer_geometry(faces)

    def t(a):
        return torch.as_tensor(np.array(a, np.float64)).to(device=device, dtype=dtype)

    def at(g, name):
        return _rounded(g[name], sample_dtype)

    def column(g, Hh):
        lam, phi = (at(g, n)[Hh:Hh + Ny, Hh:Hh + Nx] for n in ("lam_cc", "phi_cc"))
        bot = np.full(g["lam_cc"].shape, z1)
        bot[Hh:Hh + Ny, Hh:Hh + Nx] = np.broadcast_to(funcs["bottom"](lam, phi), (Ny, Nx))
        bot = fills.fill(bot, "cc", 1, Nx, Ny, Hh, Hh)
        h_c = np.clip(z1 - np.maximum(bot, z0), 0.0, None)
        return bot, h_c, np.minimum(h_c, np.roll(h_c, 1, axis=-1)), \
            np.minimum(h_c, np.roll(h_c, 1, axis=-2))

    bot, h_c, h_u, h_v = column(g64, H)
    _, _, h_ue, h_ve = column(ge64, He)
    wet = (zc[:, None, None] > _rounded(bot, sample_dtype)[None]) & (h_c > 0)[None]
    g = {k: t(a) for k, a in g64.items()}
    ge = {k: t(ge64[k]) for k in ("dy_fc", "dx_cf", "az_cc", "dx_fc", "dy_cf")}
    m = dict(Nx=Nx, Ny=Ny, H=H, He=He, nz=nz, dtype=dtype, device=device, g=g, ge=ge,
             phys=phys, weights=t(weights), dtau=float(dtau), g_acc=G_EARTH,
             sample_dtype=sample_dtype, sample={k: at(g64, k) for k in rgrid.COORDS},
             zc=zc, dz=tuple(float(x) for x in dz), dzc=tuple(float(x) for x in dzc),
             n_wet=torch.as_tensor(wet.sum(axis=0)).to(device),
             layers_per_block=max(1, POINTS_PER_BLOCK // g64["lam_cc"].size))
    m["gh_u_e"], m["gh_v_e"] = G_EARTH * t(h_ue), G_EARTH * t(h_ve)
    m["mask_u_e"], m["mask_v_e"] = t(h_ue > 0), t(h_ve > 0)
    m["mask_col"] = t(h_c > 0)
    m["f_ff"] = (2.0 * OMEGA * torch.sin(torch.deg2rad(g["phi_ff"])) if phys["coriolis"]
                 else torch.zeros_like(g["phi_ff"]))
    H_u = H_v = 0.0
    for k in range(nz):
        _, mu, mv = masks(m, k, k + 1)
        H_u, H_v = H_u + dz[k] * mu[0], H_v + dz[k] * mv[0]
    m["inv_H_u"], m["inv_H_v"] = inv(H_u), inv(H_v)
    taux = funcs["wind"](at(g64, "lam_fc"), at(g64, "phi_fc"))[0]
    tauy = funcs["wind"](at(g64, "lam_cf"), at(g64, "phi_cf"))[1]
    _, mu0, mv0 = masks(m, 0, 1)
    m["wind_u"] = t(np.broadcast_to(taux, h_u.shape)) / dz[0] * mu0[0]
    m["wind_v"] = t(np.broadcast_to(tauy, h_v.shape)) / dz[0] * mv0[0]
    return m


def masks(m, k0, k1):
    """(mask_c, mask_u, mask_v) of layers k0 ≤ k < k1, (k1 − k0, Yb, Xb)."""
    ks = torch.arange(k0, k1, device=m["device"]).view(-1, 1, 1)
    mc = (m["n_wet"] > ks).to(m["dtype"])
    return mc, mc * torch.roll(mc, 1, dims=X), mc * torch.roll(mc, 1, dims=Y)


def _blocks(m):
    step = m["layers_per_block"]
    return [(k, min(k + step, m["nz"])) for k in range(0, m["nz"], step)]


def _sample(m, fn, loc, z=None):
    """``fn`` at the interior points of ``loc`` (at depth ``z`` when given; halos 0),
    float64 numpy."""
    H, Ny, Nx = m["H"], m["Ny"], m["Nx"]
    lam, phi = m["sample"]["lam_" + loc], m["sample"]["phi_" + loc]
    out = np.zeros(lam.shape)
    val = fn(lam, phi) if z is None else fn(lam, phi, z)
    out[H:H + Ny, H:H + Nx] = np.broadcast_to(val, lam.shape)[H:H + Ny, H:H + Nx]
    return out


def initial_state(m, init):
    """The state from ``init``: u, v and each tracer functions of (λ°, φ°, z), η of
    (λ°, φ°)."""
    dt, dev, nz = m["dtype"], m["device"], m["nz"]

    def stack(fn, loc, mask):
        out = torch.empty((nz,) + m["sample"]["lam_cc"].shape, dtype=dt, device=dev)
        for k in range(nz):
            out[k] = torch.as_tensor(_sample(m, fn, loc, m["zc"][k])).to(device=dev, dtype=dt)
        for k0, k1 in _blocks(m):
            out[k0:k1] *= masks(m, k0, k1)[mask]
        return out

    u, v = stack(init["u"], "fc", 1), stack(init["v"], "cf", 2)
    c = torch.cat([stack(init[name], "cc", 0) for name in m["phys"]["tracers"]])
    eta = torch.as_tensor(_sample(m, init["eta"], "cc")).to(device=dev, dtype=dt)
    U, V = _depth_sums(m, u, v)
    zeros = torch.zeros_like(u)
    return dict(u=u, v=v, eta=_embed(m, eta * m["mask_col"]), U=_embed(m, U),
                V=_embed(m, V), c=c, b=zeros, Gu=torch.zeros_like(u), Gv=torch.zeros_like(v),
                Gc=torch.zeros_like(c), Gb=zeros, t=torch.zeros((), dtype=dt, device=dev),
                iteration=torch.zeros((), dtype=torch.int64, device=dev))


def _depth_sums(m, u, v):
    """(Σ_k dzu_k u_k, Σ_k dzv_k v_k)."""
    U = V = 0.0
    for k0, k1 in _blocks(m):
        _, mu, mv = masks(m, k0, k1)
        dz = torch.tensor(m["dz"][k0:k1], dtype=m["dtype"], device=m["device"]).view(-1, 1, 1)
        U = U + torch.sum(u[k0:k1] * dz * mu, dim=0)
        V = V + torch.sum(v[k0:k1] * dz * mv, dim=0)
    return U, V


# ------------------------------------------------------------------------------------
# The tendencies
# ------------------------------------------------------------------------------------

def _vertical(m, u, v, c):
    """(dGu, dGv, dGc): the terms that couple the layers, on halo-filled stacks: w
    from continuity, its advection of u and v, the pressure gradient of the linear
    equation of state, the centred vertical tracer flux, and explicit ν_v and κ_v
    when the vertical mixing is not implicit."""
    nz, g, phys = m["nz"], m["g"], m["phys"]
    dz, dzc = m["dz"], m["dzc"]
    explicit = phys["vertical_time_discretization"] != "implicit"
    nu_v = phys["nu_v"] if explicit else 0.0
    kappa_v = phys["kappa_v"] if explicit else 0.0
    inv_az, inv_dx, inv_dy = inv(g["az_cc"]), inv(g["dx_fc"]), inv(g["dy_cf"])
    w = [None] * (nz + 1)  # w[k] at the top of layer k; 0 at the surface and the floor
    below = None
    for k in range(nz - 1, 0, -1):
        div = dz[k] * (dxc(g["dy_fc"] * u[k]) + dyc(g["dx_cf"] * v[k])) * inv_az
        below = div if below is None else below + div
        w[k] = -below
    dGu, dGv = torch.zeros_like(u), torch.zeros_like(v)
    dGc = torch.zeros_like(c)
    for f in range(1, nz):  # interface f, between layers f − 1 and f
        mc, mu, mv = masks(m, f - 1, f + 1)
        for q, dG, shift, mq in ((u, dGu, X, mu), (v, dGv, Y, mv)):
            grad = (q[f - 1] - q[f]) / dzc[f - 1]
            adv = 0.5 * (w[f] + sm(w[f], shift)) * grad
            dG[f - 1] -= 0.5 * adv
            dG[f] -= 0.5 * adv
            if nu_v:
                flux = nu_v * grad * mq[0] * mq[1]
                dG[f - 1] -= flux / dz[f - 1]
                dG[f] += flux / dz[f]
        for i in range(len(m["phys"]["tracers"])):  # what crosses the interface upwards
            a, b = c[i * nz + f - 1], c[i * nz + f]
            up = w[f] * 0.5 * (a + b)
            if kappa_v:
                up = up - kappa_v * (a - b) / dzc[f - 1] * mc[0] * mc[1]
            dGc[i * nz + f - 1] += up / dz[f - 1]
            dGc[i * nz + f] -= up / dz[f]
    names = m["phys"]["tracers"]
    T, S = (c[names.index(n) * nz:(names.index(n) + 1) * nz] for n in ("T", "S"))
    col = 0.0
    for k in range(nz):
        mc = masks(m, k, k + 1)[0][0]
        for i in range(len(names)):
            dGc[i * nz + k] *= mc
        b = m["g_acc"] * (phys["thermal_expansion"] * (T[k] - phys["reference_temperature"])
                            - phys["haline_contraction"]
                            * (S[k] - phys["reference_salinity"])) * mc
        p = -(col + 0.5 * dz[k] * b)
        col = col + dz[k] * b
        dGu[k] -= (p - sm(p, X)) * inv_dx
        dGv[k] -= (p - sm(p, Y)) * inv_dy
    return dGu, dGv, dGc


def _momentum(m, u, v, mc, mu, mv, bottom_u, bottom_v, dz):
    """The horizontal momentum terms of a block of layers: WENO-5 vector-invariant
    advection with Coriolis, ν_h and the quadratic drag of the deepest wet layer."""
    g, phys = m["g"], m["phys"]
    zeta = (dxf(g["dy_cf"] * v) - dyf(g["dx_fc"] * u)) * inv(g["az_ff"])
    q = zeta + m["f_ff"]
    v_hat = ixf(iyc(g["dx_cf"] * v)) * inv(g["dx_fc"])
    u_hat = iyf(ixc(g["dy_fc"] * u)) * inv(g["dy_cf"])
    ke = 0.5 * (ixc(u * u) + iyc(v * v))
    Gu = weno5_centers(q, v_hat, Y) * v_hat - dxf(ke) * inv(g["dx_fc"])
    Gv = -weno5_centers(q, u_hat, X) * u_hat - dyf(ke) * inv(g["dy_cf"])
    nu = phys["nu_h"]
    if nu:  # ∇·(ν ∇u): x-fluxes at the cells, y-fluxes at the corners, each masked
        fx = nu * dxc(u) * inv(g["dx_cc"]) * g["dy_cc"] * mc
        fy = nu * dyf(u) * inv(g["dy_ff"]) * g["dx_ff"] * mu * sm(mu, Y)
        Gu = Gu + (dxf(fx) + dyc(fy)) * inv(g["az_fc"]) * mu
        fx = nu * dxf(v) * inv(g["dx_ff"]) * g["dy_ff"] * mv * sm(mv, X)
        fy = nu * dyc(v) * inv(g["dy_cc"]) * g["dx_cc"] * mc
        Gv = Gv + (dxc(fx) + dyf(fy)) * inv(g["az_cf"]) * mv
    drag, cd = phys["bottom_drag"]
    if drag == "quadratic":
        Gu = Gu - cd / dz * bottom_u * torch.sqrt(u * u + ixf(iyc(v)) ** 2) * u
        Gv = Gv - cd / dz * bottom_v * torch.sqrt(v * v + iyf(ixc(u)) ** 2) * v
    return Gu, Gv


def _tracer(m, c, u, v, mc, mu, mv, dz):
    """The horizontal terms of one tracer over a block of layers: WENO-5 flux-form
    advection through faces of the layers' thickness, and κ_h."""
    g = m["g"]
    fx = u * dz * g["dy_fc"] * weno5_faces(c, u, X)
    fy = v * dz * g["dx_cf"] * weno5_faces(c, v, Y)
    G = -(dxc(fx) + dyc(fy)) * mc * inv(g["az_cc"] * dz)
    kappa = m["phys"]["kappa_h"]
    if kappa:
        fx = kappa * dxf(c) * inv(g["dx_fc"]) * g["dy_fc"] * mu
        fy = kappa * dyf(c) * inv(g["dy_cf"]) * g["dx_cf"] * mv
        G = G + (dxc(fx) + dyc(fy)) * inv(g["az_cc"]) * mc
    return G


def tendencies(m, u, v, c):
    """(Gu, Gv, Gc) of halo-filled stacks (Gc tracer-major), masked."""
    nz = m["nz"]
    Gu, Gv, Gc = _vertical(m, u, v, c)
    for k0, k1 in _blocks(m):
        mc, mu, mv = masks(m, k0, min(k1 + 1, nz))
        n = k1 - k0
        below_u = torch.cat([mu[1:], torch.zeros_like(mu[:1])])[:n]
        below_v = torch.cat([mv[1:], torch.zeros_like(mv[:1])])[:n]
        mc, mu, mv = mc[:n], mu[:n], mv[:n]
        dz = torch.tensor(m["dz"][k0:k1], dtype=m["dtype"], device=m["device"]).view(-1, 1, 1)
        gu, gv = _momentum(m, u[k0:k1], v[k0:k1], mc, mu, mv, mu * (1 - below_u),
                           mv * (1 - below_v), dz)
        Gu[k0:k1] = (gu + Gu[k0:k1]) * mu
        Gv[k0:k1] = (gv + Gv[k0:k1]) * mv
        del gu, gv
        for i in range(len(m["phys"]["tracers"])):
            sl = slice(i * nz + k0, i * nz + k1)
            Gc[sl] = _tracer(m, c[sl], u[k0:k1], v[k0:k1], mc, mu, mv, dz) + Gc[sl]
    Gu[0] += m["wind_u"]
    Gv[0] += m["wind_v"]
    return Gu, Gv, Gc


# ------------------------------------------------------------------------------------
# The step
# ------------------------------------------------------------------------------------

def fill_state(m, s):
    """The prognostic fields with their halos filled: (u, v, c, eta, U, V)."""
    base, ext = (m["Nx"], m["Ny"], m["H"], m["H"]), (m["Nx"], m["Ny"], m["He"], m["He"])
    return (fills.fill(s["u"], "fc", -1, *base), fills.fill(s["v"], "cf", -1, *base),
            fills.fill(s["c"], "cc", 1, *base), fills.fill(s["eta"], "cc", 1, *ext),
            fills.fill(s["U"], "fc", -1, *ext), fills.fill(s["V"], "cf", -1, *ext))


def implicit_solve(m, q, r, which):
    """x with (I − r δz δz) x = q in every column (backward Euler of the vertical
    mixing, r = Δt κ [m²]): the flux between layers k − 1 and k is
    (x_{k−1} − x_k)/dzc where both are wet (``which`` 0, 1, 2: the c, u or v masks),
    none through the surface and the floor. Thomas's algorithm, a plane at a time."""
    nz, dz, dzc = m["nz"], m["dz"], m["dzc"]
    if nz == 1:
        return q
    x = torch.empty_like(q)
    upper = torch.empty_like(q)  # the superdiagonal after the elimination
    lo, here = 0.0, masks(m, 0, 1)[which][0]
    for k in range(nz):  # row k: lo x_{k-1} + (1 - lo - hi) x_k + hi x_{k+1} = q_k
        hi = 0.0
        if k + 1 < nz:
            below = masks(m, k + 1, k + 2)[which][0]
            open_ = r * here * below / dzc[k]
            hi = -open_ / dz[k]
        pivot = 1.0 - lo - hi
        if k:
            pivot = pivot - lo * upper[k - 1]
            x[k] = (q[k] - lo * x[k - 1]) / pivot
        else:
            x[k] = q[k] / pivot
        upper[k] = hi / pivot
        if k + 1 < nz:
            lo, here = -open_ / dz[k + 1], below
    for k in range(nz - 2, -1, -1):
        x[k] -= upper[k] * x[k + 1]
    return x


def step(m, s, dt):
    """One time step of state ``s`` at Δt = ``dt`` (a number): the new state."""
    phys, nz, dev, dtype = m["phys"], m["nz"], m["device"], m["dtype"]
    dt = torch.tensor(float(dt), dtype=dtype, device=dev)
    u, v, c, eta, U, V = fill_state(m, s)
    first = int(s["iteration"]) == 0
    w1, w2 = (1.0, 0.0) if first else (1.5 + CHI, 0.5 + CHI)
    Gu, Gv, Gc = tendencies(m, u, v, c)
    del u, v, c
    ext = (m["Nx"], m["Ny"], m["He"], m["He"])
    GU, GV = _depth_sums(m, w1 * Gu - w2 * s["Gu"], w1 * Gv - w2 * s["Gv"])
    GU = fills.fill(_embed(m, GU), "fc", -1, *ext)
    GV = fills.fill(_embed(m, GV), "cf", -1, *ext)
    eta_a, U_a, V_a = barotropic(m, eta, U, V, GU, GV, dt)
    implicit = phys["vertical_time_discretization"] == "implicit"
    u_new, v_new = torch.empty_like(s["u"]), torch.empty_like(s["v"])
    for k0, k1 in _blocks(m):
        _, mu, mv = masks(m, k0, k1)
        u_new[k0:k1] = (s["u"][k0:k1] + dt * (w1 * Gu[k0:k1] - w2 * s["Gu"][k0:k1])) * mu
        v_new[k0:k1] = (s["v"][k0:k1] + dt * (w1 * Gv[k0:k1] - w2 * s["Gv"][k0:k1])) * mv
    if implicit and phys["nu_v"]:
        u_new = implicit_solve(m, u_new, dt * phys["nu_v"], 1)
        v_new = implicit_solve(m, v_new, dt * phys["nu_v"], 2)
    ubar, vbar = _depth_sums(m, u_new, v_new)
    du = (_crop(m, U_a) - ubar) * m["inv_H_u"]
    dv = (_crop(m, V_a) - vbar) * m["inv_H_v"]
    n_tr = len(m["phys"]["tracers"])
    c_new = torch.empty_like(s["c"])
    for k0, k1 in _blocks(m):
        mc, mu, mv = masks(m, k0, k1)
        u_new[k0:k1] = (u_new[k0:k1] + du) * mu
        v_new[k0:k1] = (v_new[k0:k1] + dv) * mv
        for i in range(n_tr):
            sl = slice(i * nz + k0, i * nz + k1)
            c_new[sl] = (s["c"][sl] + dt * (w1 * Gc[sl] - w2 * s["Gc"][sl])) * mc
    if implicit and phys["kappa_v"]:
        for i in range(n_tr):
            sl = slice(i * nz, (i + 1) * nz)
            c_new[sl] = implicit_solve(m, c_new[sl], dt * phys["kappa_v"], 0)
    return dict(s, u=u_new, v=v_new, eta=eta_a, U=U_a, V=V_a, c=c_new, Gu=Gu, Gv=Gv, Gc=Gc,
                t=s["t"] + dt, iteration=s["iteration"] + 1)


def run(m, s, dt, n):
    """``n`` steps at ``dt``."""
    for _ in range(int(n)):
        s = step(m, s, dt)
    return s


__all__ = ["build", "initial_state", "step", "run", "tendencies", "implicit_solve",
           "masks", "layer_geometry"]
