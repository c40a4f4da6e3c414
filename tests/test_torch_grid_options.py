"""The PyTorch port's grid options and reference API against the JAX package.

- ``newton_phi_nodes`` (torch autograd through the march) against the JAX solve
  (``jax.grad`` through a ``lax.scan``): a constant law and the equatorial law of
  ``tests/test_tripolar_grid.py:238`` to atol 1e-10, the same ``ValueError`` on a
  zero law;
- ``build_tripolar_arrays(phi_spacing=law)`` against the JAX package's at (48, 24),
  rtol 1e-12; ``with_halo`` keeps the law, and a step of a model on a refined grid
  matches the JAX step at float64, rtol 1e-12 (the band of
  ``tests/test_torch_model.py``);
- the native loader (``grids/native.py``) against the numpy path at
  ``tests/test_native.py``'s tolerances, built into the port's own directory and
  leaving ``native/libtripolar_gen.so`` as it was; the "auto" rule;
- ``grids/cubed_sphere.py`` and ``cartesian_nodes`` bitwise the JAX package's;
- ``ZipperBoundaryCondition``, ``fold_north`` and ``fill_south`` as
  ``tests/test_zipper.py`` pins them, and the package's exports;
- the visualization example, as ``tests/test_examples.py`` runs the JAX one.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import orthogonalsphericalshellgrids_tpu as osg  # noqa: E402
import orthogonalsphericalshellgrids_tpu_torch as tosg  # noqa: E402
from orthogonalsphericalshellgrids_tpu.grids import cubed_sphere as jcs  # noqa: E402
from orthogonalsphericalshellgrids_tpu.grids import tripolar as jtri  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import SplitExplicitFreeSurface as JFS  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops import zipper as jzip  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.grids import cubed_sphere as tcs  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.grids import native  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.grids import tripolar as ttri  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.ops import zipper as tzip  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC, FF  # noqa: E402

torch.set_num_threads(1)

JAX_LIB = os.path.join(ROOT, "native", "libtripolar_gen.so")


def jax_equatorial(p):
    return 1.0 - 0.5 * jnp.exp(-((p / 15.0) ** 2))


def torch_equatorial(p):
    return 1.0 - 0.5 * torch.exp(-((p / 15.0) ** 2))


# ------------------------------------------------------------------------------------
# newton_phi_nodes and phi_spacing
# ------------------------------------------------------------------------------------

@pytest.mark.parametrize("Ny", [31, 61])
def test_newton_phi_nodes_constant_law(Ny):
    got = ttri.newton_phi_nodes(-80.0, Ny, lambda p: 1.0 + 0.0 * p)
    want = jtri.newton_phi_nodes(-80.0, Ny, lambda p: 1.0 + 0.0 * p)
    assert got.dtype == np.float64 and got[0] == -80.0 and got[-1] == 90.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, np.linspace(-80.0, 90.0, Ny), rtol=0, atol=1e-10)


@pytest.mark.parametrize("lo,Ny", [(-80.0, 61), (-75.0, 170)])
def test_newton_phi_nodes_equatorial_law(lo, Ny):
    """The equatorial refinement of ``tests/test_tripolar_grid.py:238``: the JAX
    rows to 1e-10, exact ends, and the equatorial spacing half the polar one."""
    got = ttri.newton_phi_nodes(lo, Ny, torch_equatorial)
    want = jtri.newton_phi_nodes(lo, Ny, jax_equatorial)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert got[0] == lo and got[-1] == 90.0
    d = np.diff(got)
    assert np.all(d > 0)
    np.testing.assert_allclose(d[np.abs(got[:-1]).argmin()] / d[-1], 0.5, rtol=1e-2)


def test_newton_phi_nodes_refuses_a_zero_law():
    with pytest.raises(ValueError, match="monotone"):
        jtri.newton_phi_nodes(-80.0, 31, lambda p: 0.0 * p)
    with pytest.raises(ValueError, match="monotone"):
        ttri.newton_phi_nodes(-80.0, 31, lambda p: 0.0 * p)
    with pytest.raises(ValueError, match="monotone"):
        ttri.TripolarGrid.make((16, 12, 1), device="cpu", phi_spacing=lambda p: 0.0 * p)


@pytest.mark.parametrize("halo", [(4, 4, 4), (5, 3, 2)])
def test_build_tripolar_arrays_with_phi_spacing(halo):
    kw = dict(halo=halo, north_poles_latitude=35.0, first_pole_longitude=45.0)
    want = jtri.build_tripolar_arrays((48, 24, 1), backend="numpy",
                                      phi_spacing=jax_equatorial, **kw)
    got = ttri.build_tripolar_arrays((48, 24, 1), phi_spacing=torch_equatorial, **kw)
    uniform = ttri.build_tripolar_arrays((48, 24, 1), **kw)
    assert got["meta"]["phi_spacing"] is torch_equatorial
    for name in ttri.ARRAY_FIELDS:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-12,
                                   atol=1e-12 * np.abs(want[name]).max(), err_msg=name)
    assert not np.allclose(got["phi_cc"], uniform["phi_cc"])
    for k, v in got["meta"].items():
        if k != "phi_spacing":
            assert want["meta"][k] == v, k


def _jet_bottom(lam, phi):
    lam_p, phi_p = 45.0, 25.0
    land = (((np.abs(lam - lam_p) < 10) & (np.abs(phi_p - phi) < 10))
            | ((np.abs(lam - (lam_p + 180.0)) < 10) & (np.abs(phi_p - phi) < 10))
            | (phi < -78))
    return np.where(land, 1.0, 0.0)


def _ui(lam, phi):
    return 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2


def _ci(lam, phi):
    return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0)


def test_with_halo_keeps_the_law():
    """``with_halo`` regenerates the refined grid: the law rides along, the rows of
    the wider grid are the narrower grid's, and they are not the uniform rows; a
    model's extended free-surface grid carries the law too."""
    kw = dict(first_pole_longitude=45.0, north_poles_latitude=25.0, dtype=torch.float64,
              device="cpu")
    grid = ttri.TripolarGrid.make((32, 24, 1), phi_spacing=torch_equatorial, **kw)
    wide = ttri.with_halo(grid, (9, 9, 1))
    assert grid.phi_spacing is torch_equatorial and wide.phi_spacing is torch_equatorial
    assert wide.halo == (9, 9, 1)
    for name in ttri.ARRAY_FIELDS[:8]:
        assert torch.equal(grid.interior(getattr(grid, name)),
                           wide.interior(getattr(wide, name))), name
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=6),
                          bottom_height=_jet_bottom, device="cpu")
    ge = model.grid_ext
    assert ge.phi_spacing is torch_equatorial and ge.Hy > grid.Hy
    uniform = ttri.TripolarGrid.make((32, 24, 1), halo=ge.halo, **kw)
    assert torch.equal(ge.interior(ge.phi_cc), grid.interior(grid.phi_cc))
    assert not torch.equal(ge.interior(ge.phi_cc), uniform.interior(uniform.phi_cc))
    # the whole extended grid, halos included, is the law's build at its halo
    raw = ttri.build_tripolar_arrays((32, 24, 1), halo=ge.halo, first_pole_longitude=45.0,
                                     north_poles_latitude=25.0,
                                     phi_spacing=torch_equatorial)
    for name in ttri.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(ge, name).numpy(), raw[name], err_msg=name)


def test_step_on_a_refined_grid_matches_jax():
    """The 32 x 24 Bickley configuration on the equatorially refined grid, built by
    each package from its own law: the initial state and two steps agree at
    float64 within rtol 1e-12."""
    kw = dict(first_pole_longitude=45.0, north_poles_latitude=25.0)
    jg = osg.TripolarGrid.make((32, 24, 1), dtype=jnp.float64, phi_spacing=jax_equatorial,
                               **kw)
    jm = JH.make_model(jg, free_surface=JFS(substeps=6), bottom_height=_jet_bottom)
    js = JH.initial_state(jm, u=_ui, c=_ci)
    tg = ttri.TripolarGrid.make((32, 24, 1), dtype=torch.float64, device="cpu",
                                phi_spacing=torch_equatorial, **kw)
    tm = TH.make_model(tg, free_surface=SplitExplicitFreeSurface(substeps=6),
                       bottom_height=_jet_bottom, device="cpu")
    ts = TH.initial_state(tm, u=_ui, c=_ci)
    jout = JH.step(jm, JH.step(jm, js, 90.0), 90.0)
    tout = TH.step(tm, TH.step(tm, ts, 90.0), 90.0)
    for a, b in ((js, ts), (jout, tout)):
        for f in dataclasses.fields(TH.State):
            want = np.asarray(getattr(a, f.name))
            got = getattr(b, f.name).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * max(np.abs(want).max(), 1e-300),
                                       err_msg=f.name)


# ------------------------------------------------------------------------------------
# the native backend
# ------------------------------------------------------------------------------------

def _jax_lib_state():
    return (os.path.exists(JAX_LIB),
            os.path.getmtime(JAX_LIB) if os.path.exists(JAX_LIB) else None)


@pytest.fixture
def native_lib():
    """The port's native library, built if needed; the JAX package's library file is
    the same before and after (it exists or not, with the same mtime)."""
    before = _jax_lib_state()
    assert native.available(), native.build_error()
    yield native
    assert _jax_lib_state() == before


def test_native_builds_into_the_port(native_lib):
    path = native._library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "orthogonalsphericalshellgrids_tpu_torch"
    assert os.path.realpath(path) != os.path.realpath(JAX_LIB)


def test_native_murray_parity(native_lib):
    nx, ny = 60, 30
    lam1 = -180.0 + (360.0 / nx) * np.arange(nx)
    phi1 = np.linspace(-80.0, 90.0, ny)
    a = ttri._tand((90.0 - 55.0) / 2.0)
    lam_np, phi_np = ttri._murray_mapping(lam1, phi1, nx, a, 70.0)
    lam_c, phi_c = native_lib.murray_coords(lam1, phi1, nx, a, 70.0)
    np.testing.assert_allclose(lam_c, lam_np, rtol=0, atol=1e-9)
    np.testing.assert_allclose(phi_c, phi_np, rtol=0, atol=1e-11)


def test_native_metric_parity(native_lib):
    raw = ttri.build_tripolar_arrays((48, 24, 1), halo=(4, 4, 4), backend="numpy")
    m = raw["meta"]
    nx, ny, hx, hy = m["Nx"], m["Ny"], m["Hx"], m["Hy"]
    coords = {k: raw[k] for k in ("lam_ff", "phi_ff", "lam_fc", "phi_fc", "lam_cf",
                                  "phi_cf", "lam_cc", "phi_cc")}
    out = native_lib.metric_arcs(coords, nx, ny, hx, hy, m["radius"])
    J, I = slice(hy, hy + ny), slice(hx, hx + nx)
    for name, arr in out.items():
        # row 1 of the numpy build is the lat-lon south continuation's
        np.testing.assert_allclose(arr[1:], raw[name][J, I][1:], rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("phi_spacing", [None, torch_equatorial])
def test_native_backend_matches_numpy(native_lib, phi_spacing):
    """The whole build through the native kernels against the numpy build, at the
    tolerances above (coordinates 1e-9 in λ, 1e-11 in φ; metrics rtol 1e-12), each
    native function called as often as the JAX package's build calls it."""
    kw = dict(halo=(4, 4, 4), north_poles_latitude=35.0, first_pole_longitude=45.0,
              phi_spacing=phi_spacing)
    calls = dict(native_lib.CALLS)
    nat = ttri.build_tripolar_arrays((48, 24, 1), backend="native", **kw)
    assert native_lib.CALLS["murray_coords"] == calls["murray_coords"] + 4
    assert native_lib.CALLS["metric_arcs"] == calls["metric_arcs"] + 1
    ref = ttri.build_tripolar_arrays((48, 24, 1), backend="numpy", **kw)
    for name in ttri.ARRAY_FIELDS:
        if name.startswith("lam"):
            np.testing.assert_allclose(nat[name], ref[name], rtol=0, atol=1e-9)
        elif name.startswith("phi"):
            np.testing.assert_allclose(nat[name], ref[name], rtol=0, atol=1e-11)
        else:
            np.testing.assert_allclose(nat[name], ref[name], rtol=1e-12, err_msg=name)


def test_auto_backend_rule(native_lib, monkeypatch):
    """"auto" takes numpy below Nx·Ny = 512·256 and the native kernels from there
    (the threshold lowered here so that the grid stays small)."""
    calls = native_lib.CALLS["murray_coords"]
    ttri.build_tripolar_arrays((16, 12, 1))
    assert native_lib.CALLS["murray_coords"] == calls
    monkeypatch.setattr(ttri, "NATIVE_FROM", 16 * 12)
    ttri.TripolarGrid.make((16, 12, 1), device="cpu")
    assert native_lib.CALLS["murray_coords"] == calls + 4


def test_native_backend_raises_when_it_cannot_build(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no compiler")
    with pytest.raises(RuntimeError, match="no compiler"):
        ttri.build_tripolar_arrays((16, 12, 1), backend="native")
    # "auto" follows the JAX package's rule: numpy where the library is unavailable
    monkeypatch.setattr(ttri, "NATIVE_FROM", 1)
    ttri.build_tripolar_arrays((16, 12, 1), backend="auto")
    with pytest.raises(ValueError, match="backend"):
        ttri.build_tripolar_arrays((16, 12, 1), backend="fortran")


# ------------------------------------------------------------------------------------
# cubed sphere, cartesian nodes, the conformal mapping
# ------------------------------------------------------------------------------------

def test_cubed_sphere_bitwise():
    r = np.random.default_rng(0)
    x, y = r.uniform(-1, 1, (2, 200))
    x[:5], y[:5] = [0.0, 1.0, -1.0, 1.0, 0.0], [0.0, 1.0, -1.0, 0.0, -1.0]
    for a, b in zip(tcs.conformal_cubed_sphere_coordinates(x, y),
                    jcs.conformal_cubed_sphere_coordinates(x, y)):
        np.testing.assert_array_equal(a, b)
    for n in (8, 33):
        tp, jp = tcs.conformal_panel_nodes(n), jcs.conformal_panel_nodes(n)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tcs.nonorthogonality_angle(*tp),
                                      jcs.nonorthogonality_angle(*jp))
    np.testing.assert_array_equal(tcs.A_RANCIC, jcs.A_RANCIC)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("loc", ["ff", "fc", "cf", "cc"])
def test_cartesian_nodes_bitwise(dtype, loc):
    kw = dict(north_poles_latitude=60.0)
    jg = osg.TripolarGrid.make((60, 30, 1), dtype=getattr(jnp, dtype), **kw)
    tg = ttri.TripolarGrid.make((60, 30, 1), dtype=getattr(torch, dtype), device="cpu",
                                **kw)
    for a, b in zip(ttri.cartesian_nodes(tg, loc), jtri.cartesian_nodes(jg, loc)):
        assert a.dtype == b.dtype and a.shape == (30, 60)
        np.testing.assert_array_equal(a, b)
    assert tg.conformal_mapping == jg.conformal_mapping


def test_tripolar_orthogonality_inside_the_panel():
    """The refined grid's non-orthogonality (singularities masked as in
    ``tests/test_tripolar_grid.py``'s refined case) lies strictly inside the
    conformal cubed-sphere panel's, with the port's own oracle."""
    raw = ttri.build_tripolar_arrays((360, 180, 1), first_pole_longitude=75.0,
                                     north_poles_latitude=35.0,
                                     phi_spacing=torch_equatorial)
    m = raw["meta"]
    lam = raw["lam_ff"][m["Hy"]:-m["Hy"], m["Hx"]:-m["Hx"]]
    phi = raw["phi_ff"][m["Hy"]:-m["Hy"], m["Hx"]:-m["Hx"]]
    from orthogonalsphericalshellgrids_tpu_torch.grids.geometry import lat_lon_to_cartesian

    ang = tcs.nonorthogonality_angle(*lat_lon_to_cartesian(phi, lam, 1.0, xp=np))
    lam_c, phi_c = lam[:-1, :-1], phi[:-1, :-1]
    sing = (((np.abs(lam_c - 75.0) < 5.5) & (np.abs(35.0 - phi_c) < 5.5))
            | ((np.abs(lam_c - 255.0) < 5.5) & (np.abs(35.0 - phi_c) < 5.5))
            | (phi_c < -78))
    masked = np.where(sing, 0.0, ang)
    cs = tcs.nonorthogonality_angle(*tcs.conformal_panel_nodes(90))[4:85, 4:85]
    assert np.max(masked) < np.max(cs) and np.min(masked) > np.min(cs)


# ------------------------------------------------------------------------------------
# the zipper API and the exports
# ------------------------------------------------------------------------------------

Nx, Ny, Hx, Hy = 10, 10, 4, 4


def _field(fn):
    A = np.zeros((Ny + 2 * Hy, Nx + 2 * Hx))
    jj, ii = np.meshgrid(np.arange(Ny), np.arange(Nx), indexing="ij")
    A[Hy:Hy + Ny, Hx:Hx + Nx] = fn(ii, jj)
    return A


def test_zipper_boundary_condition_export():
    """As ``tests/test_zipper.py:168-185``: the default sign is +1, ``apply`` is
    ``fold_north`` with the same sign (numpy and torch alike, bitwise the JAX
    package's), and a +1 sign on an FC field is honoured as it is."""
    bc = tosg.ZipperBoundaryCondition()
    assert bc.sign == 1 and tosg.ZipperBoundaryCondition(sign=-1).sign == -1
    grid = tosg.TripolarGrid.make((Nx, Ny, 1), halo=(Hx, Hy, 1), device="cpu")
    A = _field(lambda i, j: 1.0 + 2.0 * i + 3.0 * j)
    want = jzip.fold_north(A, FC, -1, Nx, Ny, Hx, Hy, xp=np)
    got = tosg.ZipperBoundaryCondition(sign=-1).apply(A, FC, grid)
    np.testing.assert_array_equal(got, want)
    got_t = tosg.ZipperBoundaryCondition(sign=-1).apply(torch.from_numpy(A), FC, grid)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(tzip.fold_north(A, FC, -1, Nx, Ny, Hx, Hy), want)
    got_pos = tosg.ZipperBoundaryCondition(sign=+1).apply(A, FC, grid)
    assert not np.array_equal(got_pos, got)
    assert A[Hy + Ny:].sum() == 0.0  # apply returns a new array


@pytest.mark.parametrize("loc,sign", [(CC, 1), (FC, -1), (CF, -1), (FF, 1)])
def test_fold_north_and_fill_south_match_jax(loc, sign):
    A = _field(lambda i, j: np.sin(1.0 + i) * (j + 2.0))
    T = torch.from_numpy(A.copy())
    want = jzip.fold_north(A, loc, sign, Nx, Ny, Hx, Hy, xp=np)
    np.testing.assert_array_equal(tzip.fold_north(A, loc, sign, Nx, Ny, Hx, Hy), want)
    out = tzip.fold_north(T, loc, sign, Nx, Ny, Hx, Hy, inplace=True)
    assert out is T
    np.testing.assert_array_equal(T.numpy(), want)
    for mode in ("zero_gradient", "none"):
        want = jzip.fill_south(A, Ny, Hy, mode, xp=np)
        np.testing.assert_array_equal(tzip.fill_south(A, Ny, Hy, mode), want)
        np.testing.assert_array_equal(
            tzip.fill_south(torch.from_numpy(A.copy()), Ny, Hy, mode).numpy(), want)
    with pytest.raises(ValueError, match="south fill"):
        tzip.fill_south(A, Ny, Hy, "periodic")


def test_exports_match_jax():
    assert sorted(tosg.__all__) == sorted(osg.__all__)
    for name in tosg.__all__:
        assert hasattr(tosg, name), name
    for name in ("CC", "CF", "FC", "FF"):
        assert getattr(tosg, name) == getattr(osg, name)
    for loc in (CC, CF, FC, FF):
        assert tosg.default_zipper_sign(loc) == osg.default_zipper_sign(loc)
    for name in ("u", "v", "c", "eta", "U", "V", "T"):
        assert tosg.sign_for_field_name(name) == osg.sign_for_field_name(name)


# ------------------------------------------------------------------------------------
# the visualization example
# ------------------------------------------------------------------------------------

def test_visualize_example(tmp_path):
    from examples.visualize_tripolar_grid_torch import main

    out = str(tmp_path / "nodes.png")
    main(out, device="cpu")
    assert os.path.getsize(out) > 10_000
