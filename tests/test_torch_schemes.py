"""The tracer-advection schemes and the centered momentum of the PyTorch port at float64.

``tests/test_schemes.py`` ported (order of accuracy on exact cell averages, linear
exactness, upwind mirror symmetry, the ``tracer_faces`` dispatch, the halo checks at
model build, a few stable steps per scheme), and against the JAX package:

- every scheme's faces, both biased WENO-5 reconstructions and ``upwind_select``,
  bitwise against the JAX functions run eagerly (the same operations in the same
  order);
- ``overlap_radius`` equal to the JAX package's for every scheme and momentum option;
- one single-layer ``step`` and one ``layered_step`` under each scheme and with the
  centered momentum (with the closures and drag those paths leave to torch), built
  from the JAX model's own arrays, against the jitted JAX steps at rtol 1e-12 of each
  field's maximum on the interior (the band of ``tests/test_tracers.py:73``: XLA:CPU
  contracts multiply-adds that eager PyTorch does not);
- the overlap split with WENO-7's radius: bitwise equal to the unsplit step and to
  serial on a halo-5 grid (4 y-shards and 2 x 2 blocks through ``LocalExchange``);
  on a halo-4 grid the split is not exact, so the default is the unsplit step,
  bitwise equal to serial, and ``overlap=True`` is refused.
"""

import os
import sys
from functools import partial
from types import SimpleNamespace

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

from test_torch_layered import (_assert_close, _jax_model, _state_numpy,  # noqa: E402
                                jax_layered_numpy)
from test_torch_model import jax_model_numpy, jax_state_numpy  # noqa: E402

from examples.bickley_jet import build as jax_bickley  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops import advection as JA  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.ops.advection import (  # noqa: E402
    SCHEME_RADIUS, TRACER_SCHEMES, centered4_faces_from_centers,
    centered_faces_from_centers, tracer_faces, upwind3_faces_from_centers, upwind_select,
    weno5_centers_from_faces, weno5_faces_from_centers, weno5_upwind_faces_from_centers,
    weno7_upwind_faces_from_centers)
from orthogonalsphericalshellgrids_tpu_torch.parallel import (  # noqa: E402
    distribute, distribute2d, gather_state, gather_state2d, make_mesh, make_mesh2d,
    sharded_step_fn, sharded_step_fn2d)

torch.set_num_threads(1)

MOMENTUM = ("weno_vector_invariant", "vector_invariant")
STATE = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ----------------------------------------------------------------------------------
# tests/test_schemes.py, ported
# ----------------------------------------------------------------------------------

def _cell_averages_of_sin(n):
    """Exact cell averages of sin on [0, 2pi) and the face coordinates."""
    h = 2 * np.pi / n
    x_face = np.arange(n) * h
    cbar = (np.cos(x_face) - np.cos(x_face + h)) / h
    return torch.as_tensor(cbar)[None, :], x_face


def _order(recon_fn, ns=(32, 64, 128)):
    errs = []
    for n in ns:
        c, x_face = _cell_averages_of_sin(n)
        f = recon_fn(c).numpy()[0]
        errs.append(np.max(np.abs(f - np.sin(x_face))))
    return [np.log2(errs[i] / errs[i + 1]) for i in range(len(errs) - 1)], errs


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_weno7_order(sign):
    """WENO-7 converges at 7th order on smooth cell averages in both upwind
    directions (the negative branch runs the mirror stencil)."""
    vel = torch.full((1, 1), sign, dtype=torch.float64)
    orders, errs = _order(lambda c: weno7_upwind_faces_from_centers(c, vel, axis=-1))
    assert all(o > 6.5 for o in orders), (errs, orders)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_upwind3_order(sign):
    vel = torch.full((1, 1), sign, dtype=torch.float64)
    orders, errs = _order(lambda c: upwind3_faces_from_centers(c, vel, axis=-1))
    assert all(o > 2.7 for o in orders), (errs, orders)


def test_centered4_order():
    orders, errs = _order(lambda c: centered4_faces_from_centers(c, axis=-1))
    assert all(o > 3.7 for o in orders), (errs, orders)


_ONES = torch.ones((1, 1), dtype=torch.float64)


@pytest.mark.parametrize("recon,radius", [
    (lambda c: weno7_upwind_faces_from_centers(c, _ONES, axis=-1), 4),
    (lambda c: upwind3_faces_from_centers(c, _ONES, axis=-1), 2),
    (lambda c: centered4_faces_from_centers(c, axis=-1), 2),
])
def test_linear_exact(recon, radius):
    """Linear data reconstructs the exact face value away from the wrap edges."""
    n = 32
    c = torch.as_tensor(0.5 + 0.25 * np.arange(n))[None, :]
    f = recon(c).numpy()[0]
    exact = 0.5 + 0.25 * (np.arange(n) - 0.5)
    s = slice(radius + 1, -(radius + 1))
    np.testing.assert_allclose(f[s], exact[s], rtol=1e-12)


def test_upwind_mirror_symmetry():
    """Face k of (c, vel > 0) equals face n - k of (c reversed, vel < 0), per scheme."""
    rng = np.random.default_rng(7)
    n = 48
    c = torch.as_tensor(rng.standard_normal(n))[None, :]
    c_rev = torch.flip(c, dims=(-1,))
    for fn in (weno5_upwind_faces_from_centers, weno7_upwind_faces_from_centers,
               upwind3_faces_from_centers):
        pos = fn(c, _ONES, axis=-1).numpy()[0]
        neg = fn(c_rev, -_ONES, axis=-1).numpy()[0]
        k = np.arange(n)
        np.testing.assert_allclose(pos, neg[(n - k) % n], rtol=1e-12, atol=1e-12)


def test_tracer_faces_dispatch():
    """Every TRACER_SCHEMES name routes to its reconstruction; unknown names raise."""
    rng = np.random.default_rng(3)
    c = torch.as_tensor(rng.standard_normal((1, 32)))
    vel = torch.as_tensor(rng.standard_normal((1, 32)))
    expect = {
        "weno5": weno5_upwind_faces_from_centers(c, vel, axis=-1),
        "weno7": weno7_upwind_faces_from_centers(c, vel, axis=-1),
        "upwind3": upwind3_faces_from_centers(c, vel, axis=-1),
        "centered": centered_faces_from_centers(c, axis=-1),
        "centered4": centered4_faces_from_centers(c, axis=-1),
    }
    for name, want in expect.items():
        assert torch.equal(tracer_faces(c, vel, axis=-1, scheme=name), want)
    assert set(expect) == set(TRACER_SCHEMES) == set(SCHEME_RADIUS)
    with pytest.raises(ValueError, match="unknown tracer_advection"):
        tracer_faces(c, vel, axis=-1, scheme="weno9")


def _grid_and_fs(halo):
    grid = TripolarGrid.make((8, 10, 1), halo=(halo, halo, halo), first_pole_longitude=45.0,
                             north_poles_latitude=35.0, dtype=torch.float64, device="cpu")
    return grid, SplitExplicitFreeSurface(substeps=4)


def _all_ocean(lam, phi):
    return np.full_like(np.asarray(lam), -2.0)


def test_make_model_rejects_scheme_on_narrow_halo():
    """weno7 (radius 4) is refused on a halo-3 grid; weno5 (radius 3) builds."""
    grid, fs = _grid_and_fs(3)
    TH.make_model(grid, free_surface=fs, bottom_height=_all_ocean, device="cpu",
                  tracer_advection="weno5")
    with pytest.raises(ValueError, match="halo"):
        TH.make_model(grid, free_surface=fs, bottom_height=_all_ocean, device="cpu",
                      tracer_advection="weno7")
    assert SCHEME_RADIUS["weno7"] == 4


def test_make_model_rejects_biharmonic_on_narrow_halo():
    """The biharmonic closures need 2 halo cells: a halo-1 centered build refuses
    nu4_h and kappa4_h."""
    grid, fs = _grid_and_fs(1)
    TH.make_model(grid, free_surface=fs, bottom_height=_all_ocean, device="cpu",
                  tracer_advection="centered")
    for kw in ({"nu4_h": 1.0e3}, {"kappa4_h": 1.0e3}):
        with pytest.raises(ValueError, match="biharmonic"):
            TH.make_model(grid, free_surface=fs, bottom_height=_all_ocean, device="cpu",
                          tracer_advection="centered", **kw)


@pytest.mark.parametrize("scheme", ["weno7", "upwind3", "centered4"])
def test_new_schemes_step_stably(scheme):
    """Five Bickley-jet steps under each scheme stay finite and in tracer range."""
    from examples.bickley_jet_torch import build

    model, state = build(nx=48, ny=24, dtype=torch.float64, substeps=8, device="cpu",
                         tracer_advection=scheme)
    out = TH.multi_step(model, state, 300.0, 5)
    c = out.c[model.grid.interior2d]
    assert torch.isfinite(out.u).all()
    assert c.min() > -1.5 and c.max() < 1.5


# ----------------------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", TRACER_SCHEMES)
@pytest.mark.parametrize("axis", [-1, -2])
def test_faces_bitwise_jax(scheme, axis):
    """Each scheme's faces of a (2, Y, X) tracer stack over a (Y, X) velocity, bitwise
    the JAX function's."""
    rng = np.random.default_rng(len(scheme) - axis)
    c = rng.standard_normal((2, 20, 30))
    vel = rng.standard_normal((20, 30))
    vel[3] = 0.0  # at rest: the negative branch
    want = np.asarray(JA.tracer_faces(jnp.asarray(c), jnp.asarray(vel), axis, scheme))
    got = tracer_faces(_t(c), _t(vel), axis, scheme).numpy()
    np.testing.assert_array_equal(got, want)


def test_biased_weno5_and_select_bitwise_jax():
    rng = np.random.default_rng(5)
    c, vel = rng.standard_normal((2, 24, 28))
    for axis in (-1, -2):
        for want, got in zip(JA.weno5_faces_from_centers(jnp.asarray(c), axis) +
                             JA.weno5_centers_from_faces(jnp.asarray(c), axis),
                             weno5_faces_from_centers(_t(c), axis) +
                             weno5_centers_from_faces(_t(c), axis)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        left, right = weno5_faces_from_centers(_t(c), axis)
        np.testing.assert_array_equal(
            upwind_select(_t(vel), left, right).numpy(),
            np.asarray(JA.upwind_select(jnp.asarray(vel), *JA.weno5_faces_from_centers(
                jnp.asarray(c), axis))))
        # the input-selected reconstruction is the selection of the two biased ones
        assert torch.equal(weno5_upwind_faces_from_centers(_t(c), _t(vel), axis),
                           upwind_select(_t(vel), left, right))


@pytest.mark.parametrize("scheme", TRACER_SCHEMES)
@pytest.mark.parametrize("momentum", MOMENTUM)
def test_overlap_radius_matches_jax(scheme, momentum):
    m = SimpleNamespace(tracer_advection=scheme, momentum_advection=momentum)
    assert TH.overlap_radius(m) == JH.overlap_radius(m)
    assert TH.overlap_radius(m) == max(SCHEME_RADIUS[scheme],
                                       3 if momentum == MOMENTUM[0] else 2)


# the single-layer options that leave the kernels, and with them the closures and
# drag those kernels would carry
SINGLE = {
    "weno7": dict(tracer_advection="weno7"),
    "upwind3": dict(tracer_advection="upwind3"),
    "centered": dict(tracer_advection="centered"),
    "centered4": dict(tracer_advection="centered4"),
    "vector_invariant": dict(momentum_advection="vector_invariant"),
    "centered_closures": dict(momentum_advection="vector_invariant",
                              tracer_advection="upwind3", nu_h=5e3, kappa_h=1e3,
                              bottom_drag=("quadratic", 2.5e-3)),
}


def _single_pair(kw):
    jm, js = jax_bickley(nx=48, ny=40, dtype=jnp.float64, substeps=30, **kw)
    arrays, meta = jax_model_numpy(jm)
    return jm, js, TH.from_jax_arrays(arrays, meta, "cpu"), \
        TH.state_from_numpy(jax_state_numpy(js), "cpu")


def _interior(grid, a):
    return np.asarray(a)[..., grid.Hy:grid.Hy + grid.Ny, grid.Hx:grid.Hx + grid.Nx]


@pytest.mark.parametrize("option", sorted(SINGLE))
def test_single_layer_step_matches_jax(option):
    jm, js, tm, ts = _single_pair(SINGLE[option])
    assert (tm.tracer_advection, tm.momentum_advection) == (jm.tracer_advection,
                                                            jm.momentum_advection)
    jout = jax.jit(partial(JH.multi_step, n_steps=1))(jm, js, 120.0)
    tout = TH.step(tm, ts, 120.0)
    g, ge = jm.grid, jm.grid_ext
    for name in STATE:
        grid = ge if name in ("eta", "U", "V") else g
        _assert_close(_interior(grid, getattr(tout, name).numpy()),
                      _interior(grid, getattr(jout, name)), 1e-12, name=name)


LAYERED = {
    "weno7": dict(tracer_advection="weno7"),
    "upwind3": dict(tracer_advection="upwind3"),
    "centered": dict(tracer_advection="centered"),
    "centered4": dict(tracer_advection="centered4"),
    "vector_invariant": dict(momentum_advection="vector_invariant"),
    # the torch-side closures and drag, and κ4_h after the plain faces
    "centered_closures": dict(momentum_advection="vector_invariant",
                              tracer_advection="centered4", tracers=("T", "S"),
                              buoyancy="linear_eos", nu_h=5e3, kappa_h=1e3,
                              bottom_drag=("quadratic", 2.5e-3), kappa4_h=1e14),
}


@pytest.mark.parametrize("option", sorted(LAYERED))
def test_layered_step_matches_jax(option):
    """One layered step of the front's options (prognostic b, ν_v, κ_v) under each
    option, against the jitted JAX step with its kernels in interpret mode."""
    cfg = dict(buoyancy=True, coriolis=True, nu_v=1e-4, kappa_v=1e-5)
    cfg.update(LAYERED[option])
    jm, js = _jax_model(cfg)
    tm = TL.layered_from_jax_arrays(*jax_layered_numpy(jm), device="cpu")
    ts = TL.layered_state_from_numpy(_state_numpy(js), device="cpu")
    jout = jax.jit(lambda m, s: JL.layered_step(m, s, 90.0, fill_mode="per"))(jm, js)
    tout = TL.layered_step(tm, ts, 90.0)
    g, ge = jm.grid, jm.grid_ext
    I3 = (slice(None),) + g.interior2d
    for name in ("u", "v", "c", "b", "Gu", "Gv", "Gc", "Gb"):
        _assert_close(getattr(tout, name).numpy(), getattr(jout, name), 1e-12, I3, name)
    for name in ("eta", "U", "V"):
        _assert_close(getattr(tout, name).numpy(), getattr(jout, name), 1e-12,
                      ge.interior2d, name)


def test_layered_fold_guards_follow_the_kernels():
    """Without the momentum kernel the closing mask is torch's (and the wind is not
    pre-masked); without the tracer kernel dGc is added in torch."""
    m, _ = _torch_layered(dict(momentum_advection="vector_invariant",
                               tracer_advection="upwind3"))
    assert not m.mom_kernel and not m.fold_mask_out
    assert not m.adv_kernel and not m.fold_tracer_acc
    m, _ = _torch_layered({})
    assert m.fold_mask_out and m.fold_tracer_acc


def _torch_layered(cfg):
    from test_torch_layered import _torch_model

    return _torch_model(dict(dict(buoyancy=True), **cfg))


# ----------------------------------------------------------------------------------
# the overlap split with WENO-7's radius
# ----------------------------------------------------------------------------------

LAM_P, PHI_P = 45.0, 35.0


def _weno7_jet(halo):
    def bottom(lam, phi):
        land = (((np.abs(lam - LAM_P) < 12) & (np.abs(PHI_P - phi) < 12))
                | ((np.abs(lam - (LAM_P + 180.0)) < 12) & (np.abs(PHI_P - phi) < 12))
                | (phi < -78))
        return np.where(land, 1.0, 0.0)

    grid = TripolarGrid.make((48, 32, 1), dtype=torch.float64, halo=(halo,) * 3,
                             first_pole_longitude=LAM_P, north_poles_latitude=PHI_P,
                             device="cpu")
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=6),
                          bottom_height=bottom, tracer_advection="weno7", device="cpu")
    # a tracer with seeded noise: its last interior row is not the fold's mirror image,
    # so a kept bulk cell that read that row before the exchange would differ
    noise = 0.1 * np.random.default_rng(halo).standard_normal(grid.shape2d)
    return model, TH.initial_state(
        model, u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
        v=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 3) * np.cos(np.deg2rad(phi) * 2),
        c=lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0) + noise)


def _sharded(model, state, mesh, overlap, n_steps=3):
    if isinstance(mesh, int):
        m = make_mesh(mesh)
        dm, ds = distribute(model, state, m)
        fn = sharded_step_fn(m, dm, overlap=overlap)
        gather = partial(gather_state, model_serial=model, n=mesh)
    else:
        m = make_mesh2d(*mesh)
        dm, ds = distribute2d(model, state, m)
        fn = sharded_step_fn2d(m, dm, model.grid.Nx, overlap=overlap)
        gather = partial(gather_state2d, model_serial=model, mesh=m)
    for _ in range(n_steps):
        ds = fn(ds, 60.0)
    fn.close()
    return gather(ds), dm


def _assert_interiors_equal(model, a, b):
    for name in STATE:
        grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
        np.testing.assert_array_equal(grid.interior(getattr(a, name)).numpy(),
                                      grid.interior(getattr(b, name)).numpy(), err_msg=name)


@pytest.fixture(scope="module")
def weno7_halo5():
    model, state = _weno7_jet(5)
    return model, state, TH.multi_step(model, state, 60.0, 3)


@pytest.mark.parametrize("mesh", [4, (2, 2)])
def test_weno7_split_bitwise(weno7_halo5, mesh):
    """WENO-7 (radius 4) on a halo-5 grid: the split is exact and on by default, and
    bitwise equal to the unsplit step and to serial."""
    model, state, serial = weno7_halo5
    assert TH.overlap_radius(model) == 4
    split, dm = _sharded(model, state, mesh, None)
    assert all(TH.overlap_supported(model, x.grid) for x in dm)
    unsplit, _ = _sharded(model, state, mesh, False)
    _assert_interiors_equal(model, split, unsplit)
    _assert_interiors_equal(model, split, serial)


@pytest.mark.parametrize("mesh", [4, (2, 2)])
def test_weno7_halo4_takes_no_split(mesh):
    """On a halo-4 grid WENO-7's radius 4 reaches the last interior row the fold
    rewrites (radius <= Hy - 1 fails): the default runs unsplit, bitwise equal to
    serial, and overlap=True is refused."""
    model, state = _weno7_jet(4)
    got, dm = _sharded(model, state, mesh, None)
    assert not any(TH.overlap_supported(model, x.grid) for x in dm)
    _assert_interiors_equal(model, got, TH.multi_step(model, state, 60.0, 3))
    with pytest.raises(ValueError, match="not exact"):
        _sharded(model, state, mesh, True, n_steps=1)
