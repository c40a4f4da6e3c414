"""The ``acc`` and ``mask_out`` operands of the port's momentum and tracer kernels, and
their fold into the layered tendencies, against the JAX package.

- ``momentum_plain`` with ``acc`` and ``mask_out`` against ``momentum_pallas(...,
  acc=, mask_out=)`` in interpret mode, one masked layer and Nz = 3, with and without
  the ν_h and drag planes, at float64 (rtol 1e-12) and float32 (2e-6,
  ``tests/test_pallas_mom.py``'s band) of the field's maximum, on cells at least the
  kernel's reach from the edge; ``tracer_adv_plain`` with ``acc`` against
  ``tracer_adv_pallas(..., acc=)`` in column and layered mode (1 and 2 tracers), with
  and without κ_h, at 1e-12. The ``acc`` planes are drawn at 1e-1 to 1 of the
  tendency, so that a band could see a term left out.
- ``layered_tendencies``, which folds the vertical kernel's (dGu, dGv, dGc) and the
  closing mask into the kernels, against the unfolded chain it replaced, bitwise up
  to the sign of zero (``torch.equal`` holds -0 == +0), for the front's and the
  gyre's options: the masks are 0 and 1, so (G + dG)·m + w·m and ((G + dG) + w)·m
  differ only in the sign of a land zero.
- The guards: with ν4_h > 0 or linear drag the momentum kernel takes no mask, with
  κ4_h > 0 the tracer kernel takes no dGc; the tendencies still equal the JAX XLA
  path (``use_pallas=False``) at rtol 1e-11, ``tests/test_torch_gyre.py``'s band.
- The wrappers refuse an operand of any other shape, a broadcast plane included.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (ROOT, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_layered import jax_layered_numpy  # noqa: E402

from examples import wind_driven_ts_gyre_torch as gyre  # noqa: E402
from orthogonalsphericalshellgrids_tpu.grids.tripolar import (  # noqa: E402
    TripolarGrid as JaxGrid)
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models.split_explicit import (  # noqa: E402
    SplitExplicitFreeSurface as JaxFS)
from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_adv import (  # noqa: E402
    pack_adv_statics, pack_adv_statics_layered, tracer_adv_pallas)
from orthogonalsphericalshellgrids_tpu.ops.pallas_mom import momentum_pallas  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import (  # noqa: E402
    momentum, tracer_adv, vertical)
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models.hydrostatic import (  # noqa: E402
    ForcingFields, _fill)
from orthogonalsphericalshellgrids_tpu_torch.ops.closures import (  # noqa: E402
    biharmonic_c, biharmonic_u, biharmonic_v)

torch.set_num_threads(1)

BANDS = {"float32": 2e-6, "float64": 1e-12}


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, rtol, name=""):
    R = momentum.REACH
    got, want = np.asarray(got)[..., R:-R, R:-R], np.asarray(want)[..., R:-R, R:-R]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=name)


# ----------------------------------------------------------------------------------
# the operands against the JAX Pallas kernels (interpret mode)
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("nz", [1, 3])
@pytest.mark.parametrize("has_lap,has_drag", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_momentum_operands_plain_matches_pallas(dtype, nz, has_lap, has_drag):
    """One masked layer (the single-layer model's layout: the masks ride in the JAX
    pack, in ``static`` here) and an unmasked Nz = 3 stack, with acc and mask_out."""
    Yb, Xb = 44, 60
    r = np.random.default_rng(100 * nz + 10 * has_lap + has_drag)
    u, v = r.standard_normal((2, nz, Yb, Xb)).astype(dtype)
    static = (1.0 + r.random((8, Yb, Xb))).astype(dtype)
    static[3] = 0.1 * r.standard_normal((Yb, Xb))  # f_ff
    L = 6 * has_lap + 2 * has_drag
    lay = (0.5 + r.random((nz, L, Yb, Xb))).astype(dtype)
    lay[:, 6 * has_lap:] *= 0.1
    masked = nz == 1
    masks = (r.random((2, Yb, Xb)) > 0.15).astype(dtype)
    acc = (0.5 * r.standard_normal((2, nz, Yb, Xb))).astype(dtype)
    mask_out = (r.random((2, nz, Yb, Xb)) > 0.2).astype(dtype)
    jlay = np.concatenate([masks[None], lay], axis=1) if masked else lay
    want = momentum_pallas(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(static),
        jnp.asarray(jlay.reshape((-1, Yb, Xb))) if jlay.shape[1] else None,
        has_mask=masked, has_lap=has_lap, has_drag=has_drag,
        acc=(jnp.asarray(acc[0]), jnp.asarray(acc[1])),
        mask_out=(jnp.asarray(mask_out[0]), jnp.asarray(mask_out[1])), interpret=True,
        block_rows=32)
    kw = dict(lay=_t(lay.reshape((-1, Yb, Xb))) if L else None, has_lap=has_lap,
              has_drag=has_drag)
    if masked:
        got = momentum.momentum(_t(u[0]), _t(v[0]), _t(np.concatenate([static, masks])),
                                acc=(_t(acc[0, 0]), _t(acc[1, 0])),
                                mask_out=(_t(mask_out[0, 0]), _t(mask_out[1, 0])), **kw)
        want = [w[0] for w in want]
    else:
        got = momentum.momentum(_t(u), _t(v), _t(static), has_mask=False,
                                acc=(_t(acc[0]), _t(acc[1])),
                                mask_out=(_t(mask_out[0]), _t(mask_out[1])), **kw)
    for name, a, w in zip(("Gu", "Gv"), got, want):
        _assert_close(a.numpy(), w, BANDS[dtype], name)


@pytest.mark.parametrize("mode,n_tr,kappa", [("column", 1, False), ("column", 1, True),
                                             ("layered", 1, False), ("layered", 2, False),
                                             ("layered", 1, True), ("layered", 2, True)])
def test_tracer_operand_plain_matches_pallas(mode, n_tr, kappa):
    """``acc`` after the advective tendency and κ_h; column mode against the JAX
    S = 3 or 6 pack, layered mode over masked velocities (S = 1 or 4)."""
    nz, Yb, Xb = 3, 44, 60
    r = np.random.default_rng(7 * n_tr + kappa + len(mode))
    if mode == "column":
        c, u, v = r.standard_normal((3, Yb, Xb))
        st = 1.0 + r.random((8 if kappa else 5, Yb, Xb))
        h_u, dy_fc, h_v, dx_cf, iv = (jnp.asarray(p) for p in st[:5])
        kap = [jnp.asarray(p)[None] for p in st[5:]]
        pack = pack_adv_statics((h_u * dy_fc)[None], (h_v * dx_cf)[None], iv[None], *kap)
        acc = 0.5 * r.standard_normal((Yb, Xb))
        want = tracer_adv_pallas(jnp.asarray(c)[None], jnp.asarray(u)[None],
                                 jnp.asarray(v)[None], statics_packed=pack,
                                 acc=jnp.asarray(acc)[None], interpret=True,
                                 block_rows=32)[0]
        got = tracer_adv.tracer_adv(_t(c), _t(u), _t(v), _t(st), acc=_t(acc))
    else:
        mask = (r.random((nz, Yb, Xb)) > 0.2).astype(np.float64)
        u = r.standard_normal((nz, Yb, Xb)) * mask
        v = r.standard_normal((nz, Yb, Xb)) * mask
        c = r.standard_normal((n_tr * nz, Yb, Xb))
        planes = (0.5 + r.random((4 if kappa else 1, nz, Yb, Xb))) * mask
        pack = np.asarray(pack_adv_statics_layered(*(jnp.asarray(a) for a in planes)))
        g = 0.5 + r.random((2, Yb, Xb))
        dz = (50.0, 120.0, 300.0)
        acc = 0.5 * r.standard_normal(c.shape)
        want = tracer_adv_pallas(jnp.asarray(c), jnp.asarray(u), jnp.asarray(v),
                                 statics_packed=jnp.asarray(pack), g_pack=jnp.asarray(g),
                                 dz=dz, acc=jnp.asarray(acc), interpret=True)
        got = tracer_adv.tracer_adv(_t(c), _t(u), _t(v), _t(pack), _t(g),
                                    torch.tensor(dz, dtype=torch.float64), acc=_t(acc))
        # the unfolded sum, bitwise: the acc add is the last operation
        plain = tracer_adv.tracer_adv(_t(c), _t(u), _t(v), _t(pack), _t(g),
                                      torch.tensor(dz, dtype=torch.float64))
        assert torch.equal(got, plain + _t(acc))
    _assert_close(got.numpy(), want, 1e-12)


def test_operands_refused_at_any_other_shape():
    nz, Yb, Xb = 3, 20, 24
    z = torch.zeros((nz, Yb, Xb), dtype=torch.float64)
    z2 = torch.zeros((Yb, Xb), dtype=torch.float64)
    plane = torch.zeros((1, Yb, Xb), dtype=torch.float64)
    st8 = torch.zeros((8, Yb, Xb), dtype=torch.float64)
    st10 = torch.zeros((10, Yb, Xb), dtype=torch.float64)
    for bad in ((z2, z2), (plane, plane), (z, plane), (z[:2], z[:2])):
        with pytest.raises(ValueError):  # a broadcast plane or another stack
            momentum.momentum(z, z, st8, has_mask=False, acc=bad)
        with pytest.raises(ValueError):
            momentum.momentum(z, z, st8, has_mask=False, mask_out=bad)
    with pytest.raises(ValueError):  # a single layer takes single planes
        momentum.momentum(z2, z2, st10, acc=(z2[None], z2[None]))
    with pytest.raises(ValueError):  # a pair, not one tensor
        momentum.momentum(z, z, st8, has_mask=False, acc=z)
    with pytest.raises(ValueError):
        momentum.momentum(z, z, st8, has_mask=False, mask_out=(z, z, z))
    with pytest.raises(TypeError):
        momentum.momentum(z, z, st8, has_mask=False, acc=(z, z.float()))
    g2 = torch.zeros((2, Yb, Xb), dtype=torch.float64)
    dz = torch.ones(nz, dtype=torch.float64)
    with pytest.raises(ValueError):  # layered: acc is shaped like c, not like u
        tracer_adv.tracer_adv(torch.zeros((2 * nz, Yb, Xb), dtype=torch.float64), z, z, z,
                              g2, dz, acc=z)
    with pytest.raises(ValueError):
        tracer_adv.tracer_adv(z, z, z, z, g2, dz, acc=plane)
    with pytest.raises(ValueError):  # column: one plane
        tracer_adv.tracer_adv(z2, z2, z2, torch.zeros((5, Yb, Xb), dtype=torch.float64),
                              acc=plane)
    with pytest.raises(ValueError):  # the refusal of a pack read at the wrong stride stays
        tracer_adv.tracer_adv(z, z, z, torch.zeros((3 * nz, Yb, Xb), dtype=torch.float64),
                              g2, dz, acc=z)


def test_cpu_operands_launch_nothing():
    kernels.reset_launch_counts()
    r = np.random.default_rng(1)
    u, v, a = _t(r.standard_normal((3, 2, 20, 24)))
    momentum.momentum(u, v, _t(r.random((8, 20, 24))), has_mask=False, acc=(a, a),
                      mask_out=(a, a))
    tracer_adv.tracer_adv(u, u, v, _t(r.random((2, 20, 24))), _t(r.random((2, 20, 24))),
                          torch.ones(2, dtype=torch.float64), acc=a)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


# ----------------------------------------------------------------------------------
# the fold in layered_tendencies
# ----------------------------------------------------------------------------------

def _unfolded_tendencies(model, u, v, c, b, t=0.0):
    """The assembly the fold replaced: the kernels without their acc/mask_out
    operands, then dGu, the wind, linear drag, −ν4_h∇⁴u and the mask, and −κ4_h∇⁴c
    and dGc, in torch."""
    g, m = model.grid, model.baro
    names = model.tracer_names
    eos = model.buoyancy == "linear_eos"
    explicit = not model.vert_impl
    dgu, dgv, dgc = vertical.vertical(
        u, v, c, b if model.has_b else None, model.n_wet, model.vert_g,
        model.vert_coef, mode=model.buoyancy,
        eos=(model.g_b, model.alpha_T, model.beta_S, model.T0, model.S0),
        it_T=names.index("T") if eos and "T" in names else -1,
        it_S=names.index("S") if eos and "S" in names else -1,
        viscous=explicit and model.nu_v > 0.0, diffusive=explicit and model.kappa_v > 0.0)
    Gu, Gv = momentum.momentum(u, v, model.mom_static, has_mask=False, lay=model.mom_lay,
                               has_lap=m.nu_h > 0.0, has_drag=m.drag_type == "quadratic")
    Gu = Gu + dgu
    Gv = Gv + dgv
    if m.wind:
        Gu[0] += m.taux / model.dz[0]
        Gv[0] += m.tauy / model.dz[0]
    if m.drag_type == "linear":
        r_dz = torch.full_like(model.dz3, m.drag_coeff) / model.dz3
        Gu = Gu - r_dz * u * model.bot_u
        Gv = Gv - r_dz * v * model.bot_v
    if m.nu4_h > 0.0:
        Gu = Gu - m.nu4_h * biharmonic_u(g, u, model.mask_u3, model.mask_c3)
        Gv = Gv - m.nu4_h * biharmonic_v(g, v, model.mask_v3, model.mask_c3)
    Gu = Gu * model.mask_u3
    Gv = Gv * model.mask_v3

    def tracer_tendency(q, dg):
        G = tracer_adv.tracer_adv(q, u, v, model.adv_pack, model.vert_g[3:5], model.dz_t)
        if m.kappa4_h > 0.0:
            q4 = q.reshape((-1, model.nz) + q.shape[-2:])
            G = G - m.kappa4_h * biharmonic_c(g, q4, model.mask_c3, model.mask_u3,
                                              model.mask_v3).reshape(q.shape)
        return G + dg

    ncp = c.shape[0]
    Gc = tracer_tendency(c, dgc[:ncp])
    Gb = tracer_tendency(b, dgc[ncp:]) if model.has_b else torch.zeros_like(b)
    if model.forcing:
        fields = ForcingFields(u=u, v=v, c=c, b=b if model.has_b else None)
        for name, fn in model.forcing:
            if name == "u":
                Gu = Gu + fn(g.lam_fc, g.phi_fc, model.zc3, t, fields) * model.mask_u3
            elif name == "v":
                Gv = Gv + fn(g.lam_cf, g.phi_cf, model.zc3, t, fields) * model.mask_v3
            elif name == "b":
                Gb = Gb + fn(g.lam_cc, g.phi_cc, model.zc3, t, fields) * model.mask_c3
            else:
                k = names.index(name)
                Gc[k * model.nz:(k + 1) * model.nz] += fn(
                    g.lam_cc, g.phi_cc, model.zc3, t, fields) * model.mask_c3
    return Gu, Gv, Gc, Gb


def _relax_u3(lam, phi, z, t, f):
    return -1e-5 * f.u


FRONT = dict(buoyancy=True, coriolis=True, nu_v=1e-4, kappa_v=1e-5)
CASES = {
    # folds on: the front's options, the gyre's (wind, ν_h, κ_h, quadratic drag) and
    # its tracer_b variant
    "front": FRONT,
    "gyre": dict(gyre.CHECK_OPTIONS),
    "gyre_tracer_b": dict(buoyancy=True, coriolis=True, nu_h=5e3, kappa_h=1e2, nu_v=1e-3,
                          kappa_v=1e-5, wind_stress=gyre.check_wind,
                          bottom_drag=("quadratic", 2.5e-3)),
    # a fold must not apply: a term lands on Gu/Gv between the kernel and the mask,
    # or on Gc between the kernel and dGc
    "nu4_h": dict(gyre.CHECK_OPTIONS, nu4_h=1e17),
    "linear_drag": dict(gyre.CHECK_OPTIONS, bottom_drag=("linear", 2e-4)),
    "kappa4_h": dict(gyre.CHECK_OPTIONS, kappa4_h=1e17),
    "all_unfolded": dict(gyre.CHECK_OPTIONS, nu_h=0.0, kappa_h=0.0, nu4_h=1e17,
                         kappa4_h=1e17, bottom_drag=("linear", 2e-4),
                         forcing={"u": _relax_u3}),
}
FOLDS = {"front": (True, True), "gyre": (True, True), "gyre_tracer_b": (True, True),
         "nu4_h": (False, True), "linear_drag": (False, True), "kappa4_h": (True, False),
         "all_unfolded": (False, False)}


def _init(case):
    init = dict(gyre.CHECK_INIT)
    if CASES[case].get("buoyancy") is True:
        init = dict(u=init["u"], v=init["v"],
                    c=lambda lam, phi, z: np.sin(np.deg2rad(phi) * 4),
                    b=lambda lam, phi, z: 1e-5 * z + 1e-4 * np.sin(np.deg2rad(lam)))
    return init


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """A case's JAX model (XLA path) and its filled initial fields, and the port's
    model built from the JAX model's leaves."""
    name = request.param
    grid = JaxGrid.make((48, 32, 3), dtype=jnp.float64, z=(-1000.0, 0.0),
                        first_pole_longitude=gyre.CHECK_LAM_P,
                        north_poles_latitude=gyre.CHECK_PHI_P)
    jm = JL.make_layered_model(grid, free_surface=JaxFS(substeps=6),
                               bottom_height=gyre.check_bottom, use_pallas=False,
                               **CASES[name])
    js = JL.layered_initial_state(jm, **_init(name))
    fields = [JL._fill3(jm, js.u, FC, -1), JL._fill3(jm, js.v, CF, -1),
              JL._fill3(jm, js.c, CC, 1), JL._fill3(jm, js.b, CC, 1) if jm.has_b else js.b]
    arrays, meta = jax_layered_numpy(jm)
    tm = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    return dict(name=name, jm=jm, fields=fields, tm=tm)


def test_fold_guards(case, monkeypatch):
    """The momentum kernel takes dGu always and the mask only without ν4_h and linear
    drag; the tracer kernel takes dGc only without κ4_h; the wind planes are made
    once, pre-masked exactly where the mask is folded."""
    tm = case["tm"]
    mask_fold, acc_fold = FOLDS[case["name"]]
    assert (tm.fold_mask_out, tm.fold_tracer_acc) == (mask_fold, acc_fold)
    seen = {"mom": [], "adv": []}
    mom, adv = momentum.momentum, tracer_adv.tracer_adv

    def spy_mom(*a, **kw):
        seen["mom"].append((kw.get("acc") is not None, kw.get("mask_out") is not None))
        return mom(*a, **kw)

    def spy_adv(*a, **kw):
        seen["adv"].append(kw.get("acc") is not None)
        return adv(*a, **kw)

    monkeypatch.setattr(momentum, "momentum", spy_mom)
    monkeypatch.setattr(tracer_adv, "tracer_adv", spy_adv)
    TL.layered_tendencies(tm, *(_t(a) for a in case["fields"]))
    assert seen["mom"] == [(True, mask_fold)]
    assert seen["adv"] == [acc_fold] * (1 + tm.has_b)
    m = tm.baro
    if m.wind:
        wu = m.taux / tm.dz[0]
        assert torch.equal(tm.wind_u, wu * tm.mask_u3[0] if mask_fold else wu)
    else:
        assert tm.wind_u is None and tm.wind_v is None


def test_folded_tendencies_equal_the_unfolded_chain(case):
    """Bitwise up to the sign of zero, on every cell."""
    tm = case["tm"]
    fields = [_t(a) for a in case["fields"]]
    t = torch.tensor(1800.0, dtype=torch.float64)
    got = TL.layered_tendencies(tm, *fields, t=t)
    want = _unfolded_tendencies(tm, *fields, t=t)
    for name, a, w in zip(("Gu", "Gv", "Gc", "Gb"), got, want):
        assert torch.equal(a, w), name


def test_tendencies_match_jax_xla_path(case):
    """The folded (or, past a guard, unfolded) tendencies against the JAX XLA path at
    rtol 1e-11 on the interior."""
    jm, tm = case["jm"], case["tm"]
    t = 1800.0
    want = JL.layered_tendencies(jm, *case["fields"], t=jnp.asarray(t))
    got = TL.layered_tendencies(tm, *(_t(a) for a in case["fields"]),
                                t=torch.tensor(t, dtype=torch.float64))
    I3 = (slice(None),) + jm.grid.interior2d
    for name, a, w in zip(("Gu", "Gv", "Gc", "Gb"), got, want):
        a, w = a.numpy()[I3], np.asarray(w)[I3]
        np.testing.assert_allclose(a, w, rtol=1e-11, atol=1e-11 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)
