"""The PyTorch port's gyre options against the JAX package at float64: the closures,
wind, drag and forcing of both models, the fused closure planes of the momentum and
tracer kernels, and the corrector.

- ``ops/closures.py`` against the JAX functions, bitwise (same op order, eager).
- The plain kernel versions against the JAX Pallas kernels in interpret mode, as
  the JAX package's own tests run them, at rtol 1e-12 of the field's maximum on
  cells at least the kernel's reach from the edge: ``momentum_plain`` with ν_h and
  drag (one masked layer and Nz = 3), ``tracer_adv_plain`` with κ_h (column S = 6,
  layered S = 4), ``corrector_plain`` with and without b.
- The wrappers refuse a pack of the wrong stride.
- Single-layer ``tendencies`` with each option, and three steps, against the JAX
  XLA path (``use_pallas=False``) at rtol 1e-11: the port follows the kernel path's
  order of terms, the XLA path another, so the two differ by rounding.
- The 48 x 32 x 3 gyre of ``tests/test_layered_kernels.py:45-81`` (and its tracer_b
  variant, ``:130-161``): the port's build equal to the JAX model's arrays, then
  ``layered_tendencies`` and three ``layered_step``s of the port's plain path
  (built from the JAX model's own arrays) against the jitted JAX ``use_pallas=False``
  path at rtol 1e-11, that file's band (lines 101 and 121).
"""

import dataclasses
import os
import sys
import types
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (ROOT, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_layered import jax_layered_numpy  # noqa: E402
from test_torch_model import jax_model_numpy, jax_state_numpy  # noqa: E402

from examples.bickley_jet import build as jax_bickley  # noqa: E402
from examples import wind_driven_ts_gyre_torch as gyre  # noqa: E402
from orthogonalsphericalshellgrids_tpu.grids.tripolar import (  # noqa: E402
    TripolarGrid as JaxGrid)
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models.split_explicit import (  # noqa: E402
    SplitExplicitFreeSurface as JaxFS)
from orthogonalsphericalshellgrids_tpu.ops import closures as JC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_adv import (  # noqa: E402
    pack_adv_statics, pack_adv_statics_layered, tracer_adv_pallas)
from orthogonalsphericalshellgrids_tpu.ops.pallas_corr import corrector_pallas  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_mom import momentum_pallas  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import (  # noqa: E402
    corrector, momentum, tracer_adv)
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops import closures as TC  # noqa: E402

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, rtol, sl=(Ellipsis,), name=""):
    got, want = np.asarray(got)[sl], np.asarray(want)[sl]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=name)


def _inner(R):
    return (Ellipsis, slice(R, -R), slice(R, -R))


# ----------------------------------------------------------------------------------
# ops/closures.py, bitwise
# ----------------------------------------------------------------------------------

CLOSURE_ARRAYS = ("dx_cc", "dy_cc", "dx_ff", "dy_ff", "dx_fc", "dy_fc", "dx_cf", "dy_cf",
                  "az_fc", "az_cf", "az_cc")


@pytest.fixture(scope="module")
def closure_grid():
    g = JaxGrid.make((24, 20, 1), halo=(5, 5, 5), dtype=jnp.float64,
                     first_pole_longitude=45.0, north_poles_latitude=25.0)
    tg = types.SimpleNamespace(**{n: _t(getattr(g, n)) for n in CLOSURE_ARRAYS})
    return g, tg


@pytest.mark.parametrize("name", ["laplacian_u", "laplacian_v", "laplacian_c",
                                  "biharmonic_u", "biharmonic_v", "biharmonic_c"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_closures_bitwise(closure_grid, name, lead):
    g, tg = closure_grid
    r = np.random.default_rng(len(name) + len(lead))
    shape = lead + g.shape2d
    q = r.standard_normal(shape)
    m1, m2, m3 = (r.random((3,) + shape) > 0.2).astype(np.float64)
    masks = (m1, m2) if name[-1] in "uv" else (m1, m2, m3)
    want = getattr(JC, name)(g, jnp.asarray(q), *(jnp.asarray(m) for m in masks))
    got = getattr(TC, name)(tg, _t(q), *(_t(m) for m in masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------------
# plain kernel versions against the JAX Pallas kernels (interpret mode)
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("nz", [1, 3])
@pytest.mark.parametrize("has_lap,has_drag", [(True, False), (False, True), (True, True)])
def test_momentum_closures_plain_matches_pallas(nz, has_lap, has_drag):
    """One masked layer (the single-layer model) and an unmasked Nz = 3 stack (the
    layered model), with the ν_h planes, the drag planes or both."""
    Yb, Xb = 52, 64
    r = np.random.default_rng(10 * nz + 2 * has_lap + has_drag)
    u, v = r.standard_normal((2, nz, Yb, Xb))
    static = 1.0 + r.random((8, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))  # f_ff
    L = 6 * has_lap + 2 * has_drag
    lay = (0.5 + r.random((nz, L, Yb, Xb))) * (r.random((nz, L, Yb, Xb)) > 0.1)
    masked = nz == 1
    masks = (r.random((2, Yb, Xb)) > 0.15).astype(np.float64)
    jlay = np.concatenate([masks[None], lay], axis=1) if masked else lay
    want = momentum_pallas(jnp.asarray(u), jnp.asarray(v), jnp.asarray(static),
                           jnp.asarray(jlay.reshape((-1, Yb, Xb))), has_mask=masked,
                           has_lap=has_lap, has_drag=has_drag, interpret=True,
                           block_rows=32)
    if masked:
        got = momentum.momentum(_t(u[0]), _t(v[0]), _t(np.concatenate([static, masks])),
                                lay=_t(lay[0]), has_lap=has_lap, has_drag=has_drag)
        want = [w[0] for w in want]
    else:
        got = momentum.momentum(_t(u), _t(v), _t(static), has_mask=False,
                                lay=_t(lay.reshape((-1, Yb, Xb))), has_lap=has_lap,
                                has_drag=has_drag)
    for name, a, w in zip(("Gu", "Gv"), got, want):
        _assert_close(a.numpy(), w, 1e-12, _inner(momentum.REACH), name)


def test_tracer_adv_kappa_column_plain_matches_pallas():
    """Column mode with κ_h: the port's 8-plane pack against the JAX S = 6 pack."""
    Yb, Xb = 52, 64
    r = np.random.default_rng(21)
    c, u, v = r.standard_normal((3, Yb, Xb))
    st = 1.0 + r.random((8, Yb, Xb))
    h_u, dy_fc, h_v, dx_cf, iv, ku, kv, kc = (jnp.asarray(p) for p in st)
    pack = pack_adv_statics((h_u * dy_fc)[None], (h_v * dx_cf)[None], iv[None], ku[None],
                            kv[None], kc[None])
    want = tracer_adv_pallas(jnp.asarray(c)[None], jnp.asarray(u)[None],
                             jnp.asarray(v)[None], statics_packed=pack, interpret=True,
                             block_rows=32)[0]
    got = tracer_adv.tracer_adv(_t(c), _t(u), _t(v), _t(st))
    _assert_close(got.numpy(), want, 1e-12, _inner(tracer_adv.REACH))


@pytest.mark.parametrize("n_tr", [1, 2])
def test_tracer_adv_kappa_layered_plain_matches_pallas(n_tr):
    """Layered mode with κ_h, S = 4, over masked velocities."""
    nz, Yb, Xb = 3, 44, 60
    r = np.random.default_rng(30 + n_tr)
    mask = (r.random((nz, Yb, Xb)) > 0.2).astype(np.float64)
    u = r.standard_normal((nz, Yb, Xb)) * mask
    v = r.standard_normal((nz, Yb, Xb)) * mask
    c = r.standard_normal((n_tr * nz, Yb, Xb))
    iv, ku, kv, kc = (0.5 + r.random((4, nz, Yb, Xb))) * mask
    g = 0.5 + r.random((2, Yb, Xb))
    dz = (50.0, 120.0, 300.0)
    pack = np.asarray(pack_adv_statics_layered(*(jnp.asarray(a) for a in (iv, ku, kv, kc))))
    want = tracer_adv_pallas(jnp.asarray(c), jnp.asarray(u), jnp.asarray(v),
                             statics_packed=jnp.asarray(pack), g_pack=jnp.asarray(g),
                             dz=dz, interpret=True)
    got = tracer_adv.tracer_adv(_t(c), _t(u), _t(v), _t(pack), _t(g),
                                torch.tensor(dz, dtype=torch.float64))
    _assert_close(got.numpy(), want, 1e-12, _inner(tracer_adv.REACH))


def _corrector_inputs(nz, n_tr, Yb, Xb, seed):
    r = np.random.default_rng(seed)
    mu, mv, mc = (r.random((3, nz, Yb, Xb)) > 0.2).astype(np.float64)
    dz3 = np.array([40.0 * 1.3 ** k for k in range(nz)]).reshape(-1, 1, 1)
    stacks = [r.standard_normal((nz, Yb, Xb)) * mu, r.standard_normal((nz, Yb, Xb)),
              r.standard_normal((nz, Yb, Xb)), r.standard_normal((nz, Yb, Xb)) * mv,
              r.standard_normal((nz, Yb, Xb)), r.standard_normal((nz, Yb, Xb))]
    tracers = [r.standard_normal((n_tr * nz, Yb, Xb)) for _ in range(3)]
    b = [r.standard_normal((nz, Yb, Xb)) for _ in range(3)]
    ihu = r.random((Yb, Xb)) * (mu.max(0) > 0)
    ihv = r.random((Yb, Xb)) * (mv.max(0) > 0)
    Ua, Va = r.standard_normal((2, Yb, Xb))
    return stacks, tracers, b, dz3 * mu, dz3 * mv, mc, ihu, ihv, Ua, Va


@pytest.mark.parametrize("with_b", [False, True])
def test_corrector_plain_matches_pallas(with_b):
    """The b planes ride appended to the tracer stack in the JAX kernel
    (``layered.py:1133-1136``) and as their own operands in the port."""
    nz, n_tr, Yb, Xb = 4, 2, 40, 56
    stacks, tr, b, dzu, dzv, mc, ihu, ihv, Ua, Va = _corrector_inputs(nz, n_tr, Yb, Xb, 3)
    w1, w2, dt = 1.6, 0.6, 37.5
    jtr = [np.concatenate([a, bb]) for a, bb in zip(tr, b)] if with_b else tr
    want = corrector_pallas(*(jnp.asarray(a) for a in stacks + jtr),
                            jnp.asarray(dzu), jnp.asarray(dzv), jnp.asarray(mc),
                            jnp.asarray(ihu), jnp.asarray(ihv), jnp.asarray(Ua),
                            jnp.asarray(Va), w1, w2, dt, interpret=True)
    scal = [torch.tensor(x, dtype=torch.float64) for x in (w1, w2, dt)]
    got = corrector.corrector(*(_t(a) for a in stacks + tr + [dzu, dzv, mc, ihu, ihv, Ua,
                                                              Va]),
                              *scal, b=tuple(_t(a) for a in b) if with_b else None)
    P = n_tr * nz
    want_b = np.asarray(want[2])[P:] if with_b else None
    for name, a, w in (("u", got[0], want[0]), ("v", got[1], want[1]),
                       ("c", got[2], np.asarray(want[2])[:P])):
        _assert_close(a.numpy(), w, 1e-12, name=name)
    if with_b:
        _assert_close(got[3].numpy(), want_b, 1e-12, name="b")
    else:
        assert got[3] is None


def test_corrector_reads_a_cropped_view():
    """U_a and V_a go in as views of the widened free-surface arrays."""
    nz, Yb, Xb, d = 3, 20, 28, 4
    stacks, tr, _, dzu, dzv, mc, ihu, ihv, Ua, Va = _corrector_inputs(nz, 1, Yb, Xb, 5)
    ext = np.zeros((2, Yb + 2 * d, Xb + 2 * d))
    ext[0, d:-d, d:-d], ext[1, d:-d, d:-d] = Ua, Va
    E = _t(ext)
    args = [_t(a) for a in stacks + tr + [dzu, dzv, mc, ihu, ihv]]
    scal = [torch.tensor(x, dtype=torch.float64) for x in (1.6, 0.6, 20.0)]
    got = corrector.corrector(*args, E[0, d:-d, d:-d], E[1, d:-d, d:-d], *scal)
    want = corrector.corrector_plain(*args, _t(Ua), _t(Va), *scal)
    for a, w in zip(got[:3], want[:3]):
        assert torch.equal(a, w)


def test_wrappers_refuse_wrong_strides():
    nz, Yb, Xb = 3, 20, 24
    z = torch.zeros((nz, Yb, Xb), dtype=torch.float64)
    z2 = torch.zeros((Yb, Xb), dtype=torch.float64)
    g2 = torch.zeros((2, Yb, Xb), dtype=torch.float64)
    dz = torch.ones(nz, dtype=torch.float64)
    with pytest.raises(ValueError):  # the JAX column pack (S = 6) is not the port's
        tracer_adv.tracer_adv(z2, z2, z2, torch.zeros((6, Yb, Xb), dtype=torch.float64))
    with pytest.raises(ValueError):  # a layered pack of S = 2
        tracer_adv.tracer_adv(z, z, z, torch.zeros((2 * nz, Yb, Xb), dtype=torch.float64),
                              g2, dz)
    st8 = torch.zeros((8, Yb, Xb), dtype=torch.float64)
    with pytest.raises(ValueError):  # a ν_h + drag pack is 8 planes a layer, not 6
        momentum.momentum(z, z, st8, has_mask=False,
                          lay=torch.zeros((6 * nz, Yb, Xb), dtype=torch.float64),
                          has_lap=True, has_drag=True)
    with pytest.raises(ValueError):  # a pack without its flags
        momentum.momentum(z, z, st8, has_mask=False,
                          lay=torch.zeros((2 * nz, Yb, Xb), dtype=torch.float64))
    with pytest.raises(ValueError):  # flags without their pack
        momentum.momentum(z, z, st8, has_mask=False, has_drag=True)
    s0 = torch.zeros((), dtype=torch.float64)
    with pytest.raises(ValueError):  # U_a must have unit x stride
        corrector.corrector(z, z, z, z, z, z, z, z, z, z, z, z, z2, z2, z2.t(), z2,
                            s0, s0, s0)


def test_cpu_closure_modes_launch_nothing():
    kernels.reset_launch_counts()
    nz, Yb, Xb = 2, 24, 28
    r = np.random.default_rng(0)
    u, v = _t(r.standard_normal((2, nz, Yb, Xb)))
    momentum.momentum(u, v, _t(r.random((8, Yb, Xb))), has_mask=False,
                      lay=_t(r.random((8 * nz, Yb, Xb))), has_lap=True, has_drag=True)
    tracer_adv.tracer_adv(u, u, v, _t(r.random((4 * nz, Yb, Xb))), _t(r.random((2, Yb, Xb))),
                          torch.ones(nz, dtype=torch.float64))
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


# ----------------------------------------------------------------------------------
# the single-layer model's options
# ----------------------------------------------------------------------------------

def _relax_u(lam, phi, t, f):
    return -1e-5 * f.u


def _heat_c(lam, phi, t, f):
    return 1e-7 * (1.0 + 1e-4 * t) * (phi * 0.01)


SINGLE_OPTIONS = {
    "nu_h": dict(nu_h=5e3),
    "kappa_h": dict(kappa_h=1e3),
    "nu4_h": dict(nu4_h=1e17),
    "kappa4_h": dict(kappa4_h=1e17),
    "linear_drag": dict(bottom_drag=("linear", 1e-3)),
    "quadratic_drag": dict(bottom_drag=("quadratic", 2.5e-3)),
    "wind": dict(wind_stress=lambda lam, phi: (1e-4 * np.cos(np.deg2rad(phi)),
                                               -3e-5 * np.sin(np.deg2rad(lam)))),
    "forcing": dict(forcing={"u": _relax_u, "v": lambda lam, phi, t, f: -2e-5 * f.v,
                             "c": _heat_c}),
}
SINGLE_ALL = dict(SINGLE_OPTIONS["nu_h"], **SINGLE_OPTIONS["kappa_h"],
                  **SINGLE_OPTIONS["quadratic_drag"], **SINGLE_OPTIONS["wind"])


def _single_pair(kw):
    jm, js = jax_bickley(nx=48, ny=40, dtype=jnp.float64, substeps=30, **kw)
    arrays, meta = jax_model_numpy(jm)
    return jm, js, TH.from_jax_arrays(arrays, meta, "cpu"), \
        TH.state_from_numpy(jax_state_numpy(js), "cpu")


def _interior(grid, a):
    return np.asarray(a)[..., grid.Hy:grid.Hy + grid.Ny, grid.Hx:grid.Hx + grid.Nx]


@pytest.mark.parametrize("option", sorted(SINGLE_OPTIONS))
def test_single_layer_tendencies_match_jax(option):
    jm, js, tm, _ = _single_pair(SINGLE_OPTIONS[option])
    g = jm.grid
    u, v, c = (JH._fill(g, a, loc, s) for a, loc, s in
               ((js.u, FC, -1), (js.v, CF, -1), (js.c, CC, 1)))
    t = 3600.0
    want = JH.tendencies(jm, u, v, c, t=jnp.asarray(t))
    got = TH.tendencies(tm, *(_t(a) for a in (u, v, c)), t=torch.tensor(t,
                                                                      dtype=torch.float64))
    for name, w, a in zip(("Gu", "Gv", "Gc"), want, got):
        _assert_close(_interior(g, a.numpy()), _interior(g, w), 1e-11, name=name)


@pytest.mark.parametrize("case", ["closures_wind_drag", "biharmonic_linear_forcing"])
def test_single_layer_steps_match_jax(case):
    kw = SINGLE_ALL if case == "closures_wind_drag" else dict(
        SINGLE_OPTIONS["nu4_h"], **SINGLE_OPTIONS["kappa4_h"],
        **SINGLE_OPTIONS["linear_drag"], **SINGLE_OPTIONS["forcing"])
    jm, js, tm, ts = _single_pair(kw)
    jout = jax.jit(partial(JH.multi_step, n_steps=3))(jm, js, 120.0)
    tout = TH.multi_step(tm, ts, 120.0, 3)
    g, ge = jm.grid, jm.grid_ext
    for name in ("u", "v", "c", "Gu", "Gv", "Gc"):
        _assert_close(_interior(g, getattr(tout, name).numpy()),
                      _interior(g, getattr(jout, name)), 1e-11, name=name)
    for name in ("eta", "U", "V"):
        _assert_close(_interior(ge, getattr(tout, name).numpy()),
                      _interior(ge, getattr(jout, name)), 1e-11, name=name)


def test_single_layer_build_matches_jax():
    """The port's own make_model gives the JAX model's closure planes and wind, the
    same planes ``from_jax_arrays`` carries over."""
    from examples.bickley_jet_torch import build as torch_bickley

    jm, _, tj, _ = _single_pair(SINGLE_ALL)
    tm, _ = torch_bickley(nx=48, ny=40, dtype=torch.float64, substeps=30, device="cpu",
                          **SINGLE_ALL)
    np.testing.assert_array_equal(tm.mom_lay.numpy(), np.asarray(jm.mom_lay)[2:])
    np.testing.assert_array_equal(tm.adv_pack[5:].numpy(), np.asarray(jm.adv_pack)[3:])
    for name in ("taux", "tauy"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))
    for name in ("mom_lay", "adv_pack", "taux", "tauy"):
        assert torch.equal(getattr(tm, name), getattr(tj, name)), name
    for name in TH.OPTIONS:
        if name != "forcing":
            assert getattr(tm, name) == getattr(jm, name) == getattr(tj, name), name


# ----------------------------------------------------------------------------------
# the layered gyre
# ----------------------------------------------------------------------------------

def _relax_u3(lam, phi, z, t, f):
    return -1e-5 * f.u


def _heat_T(lam, phi, z, t, f):
    return 1e-7 * (1.0 + 1e-4 * t) * (z / 1000.0) * (phi * 0.0 + 1.0)


LAYERED = {
    # tests/test_layered_kernels.py:45-81: the gyre's options on 48 x 32 x 3
    "gyre": dict(gyre.CHECK_OPTIONS),
    # :130-161: prognostic b, one passive tracer, the same closures, no wind
    "tracer_b": dict(buoyancy=True, coriolis=True, nu_h=5e3, kappa_h=1e2, nu_v=1e-3,
                     kappa_v=1e-5, bottom_drag=("quadratic", 2.5e-3)),
    # the options the gyre does not reach: biharmonic, linear drag, forcing
    "biharmonic_forcing": dict(
        gyre.CHECK_OPTIONS, nu_h=0.0, kappa_h=0.0, nu4_h=1e17, kappa4_h=1e17,
        bottom_drag=("linear", 2e-4),
        forcing={"u": _relax_u3, "T": _heat_T,
                 "v": lambda lam, phi, z, t, f: -2e-5 * f.v}),
}


def _layered_init(case):
    init = dict(gyre.CHECK_INIT)
    if case == "tracer_b":
        init = dict(u=init["u"], c=lambda lam, phi, z: np.sin(np.deg2rad(phi) * 4),
                    b=lambda lam, phi, z: 1e-5 * z + 1e-4 * np.sin(np.deg2rad(lam)))
    return init


def _jax_gyre(case):
    grid = JaxGrid.make((48, 32, 3), dtype=jnp.float64, z=(-1000.0, 0.0),
                        first_pole_longitude=gyre.CHECK_LAM_P,
                        north_poles_latitude=gyre.CHECK_PHI_P)
    m = JL.make_layered_model(grid, free_surface=JaxFS(substeps=6),
                              bottom_height=gyre.check_bottom, use_pallas=False,
                              **LAYERED[case])
    return m, JL.layered_initial_state(m, **_layered_init(case))


def _state_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


@pytest.fixture(scope="module", params=sorted(LAYERED))
def gyre_run(request):
    """A case's JAX model (XLA path) and state, the port's model and state built
    from their leaves, and the JAX states after 1 and 3 jitted steps."""
    jm, js = _jax_gyre(request.param)
    arrays, meta = jax_layered_numpy(jm)
    tm = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    ts = TL.layered_state_from_numpy(_state_numpy(js), device="cpu")
    step = jax.jit(lambda m, s: JL.layered_step(m, s, 60.0))
    out, s = {}, js
    for n in range(1, 4):
        s = step(jm, s)
        out[n] = s
    return dict(case=request.param, jm=jm, js=js, tm=tm, ts=ts, jout=out)


def test_layered_gyre_tendencies_match_jax(gyre_run):
    jm, js, tm = gyre_run["jm"], gyre_run["js"], gyre_run["tm"]
    u = JL._fill3(jm, js.u, FC, -1)
    v = JL._fill3(jm, js.v, CF, -1)
    c = JL._fill3(jm, js.c, CC, 1)
    b = JL._fill3(jm, js.b, CC, 1) if jm.has_b else js.b
    t = 1800.0
    want = JL.layered_tendencies(jm, u, v, c, b, t=jnp.asarray(t))
    got = TL.layered_tendencies(tm, *(_t(a) for a in (u, v, c, b)),
                                t=torch.tensor(t, dtype=torch.float64))
    I3 = (slice(None),) + jm.grid.interior2d
    for name, a, w in zip(("Gu", "Gv", "Gc", "Gb"), got, want):
        _assert_close(a.numpy(), w, 1e-11, I3, name)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_layered_gyre_steps_match_jax(gyre_run, n_steps):
    jm, tm, ts = gyre_run["jm"], gyre_run["tm"], gyre_run["ts"]
    jout = gyre_run["jout"][n_steps]
    before = {k: v.clone() for k, v in dataclasses.asdict(ts).items()}
    kernels.reset_launch_counts()
    tout = TL.layered_multi_step(tm, ts, 60.0, n_steps)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}  # plain path
    g, ge = jm.grid, jm.grid_ext
    I3 = (slice(None),) + g.interior2d
    for name in ("u", "v", "c", "b", "Gu", "Gv", "Gc", "Gb"):
        _assert_close(getattr(tout, name).numpy(), getattr(jout, name), 1e-11, I3, name)
    for name in ("eta", "U", "V"):
        _assert_close(getattr(tout, name).numpy(), getattr(jout, name), 1e-11,
                      ge.interior2d, name)
    for k, v in before.items():
        assert torch.equal(getattr(ts, k), v), f"step mutated state.{k}"


def test_layered_gyre_build_matches_jax():
    """The port's own build of the check gyre (``build_check``) equals the JAX
    model's arrays, the closure packs included, and so does ``layered_from_jax_arrays``."""
    jm, js = _jax_gyre("gyre")
    tm, ts = gyre.build_check(device="cpu")
    arrays, meta = jax_layered_numpy(jm)
    tj = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    for name in TL.BUFFERS + ("mom_lay",):
        want = np.asarray(getattr(jm, name))
        np.testing.assert_array_equal(getattr(tm, name).numpy(), want, err_msg=name)
        np.testing.assert_array_equal(getattr(tj, name).numpy(), want, err_msg=name)
    assert tm.mom_lay.shape == (3 * 8,) + jm.grid.shape2d
    assert tm.adv_pack.shape == (3 * 4,) + jm.grid.shape2d
    for name in ("taux", "tauy"):
        np.testing.assert_array_equal(getattr(tm.baro, name).numpy(),
                                      np.asarray(getattr(jm.baro, name)))
    for name in ("c", "u", "v", "eta"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


def test_layered_forcing_carried_across():
    """``layered_from_jax_arrays`` keeps the forcing functions and the closure
    metadata of the embedded model."""
    jm, _ = _jax_gyre("biharmonic_forcing")
    arrays, meta = jax_layered_numpy(jm)
    tm = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    assert [n for n, _ in tm.forcing] == ["u", "T", "v"]
    assert tm.forcing[0][1] is _relax_u3
    assert tm.mom_lay is None and tm.adv_pack.shape[0] == 3
    assert (tm.baro.nu4_h, tm.baro.kappa4_h, tm.baro.drag_type) == (1e17, 1e17, "linear")


def test_gyre_example_builds_on_cpu():
    """``examples/wind_driven_ts_gyre_torch.build`` at a small size: stretched layers
    (taper 1.7), the closure packs, and a finite step."""
    model, state = gyre.build(nx=36, ny=20, nz=4, dtype=torch.float64, substeps=6,
                              device="cpu")
    dz = np.array(model.dz)
    np.testing.assert_allclose(dz[1:] / dz[:-1], 1.7, rtol=1e-12)
    assert model.mom_lay.shape[0] == 8 * 4 and model.adv_pack.shape[0] == 4 * 4
    assert model.baro.wind and model.baro.drag_type == "quadratic"
    out = TL.layered_step(model, state, 300.0)
    for name in ("u", "v", "c"):
        assert bool(torch.isfinite(getattr(out, name)).all()), name
