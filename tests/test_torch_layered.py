"""The PyTorch port's layered engine against the JAX package at float64.

- The plain versions of the three layered kernels against the JAX Pallas kernels in
  interpret mode, as the JAX package's own tests run them: ``vertical_plain``
  against ``vertical_pallas`` in its three modes with S = 1 and 3, the layered
  ``momentum_plain`` against ``momentum_pallas(u3, v3, mom_static, None)`` and the
  layered ``tracer_adv_plain`` against ``tracer_adv_pallas(..., g_pack=, dz=)``.
  Band: ``tests/test_pallas_vert.py``'s, rtol 1e-12 relative to the field's maximum
  (2e-6 for the float32 momentum case, as ``tests/test_pallas_mom.py``), on cells at
  least the kernel's reach (1, 5, 4) from the array edge.
- ``vertical_plain`` against the port's own XLA-style vertical operators (an
  independent statement of the same terms), and the horizontal operators of
  ``ops/`` over a leading layer axis against the same operators layer by layer.
- ``make_layered_model``/``layered_initial_state`` equal to the JAX arrays exactly (U/V,
  the depth sums, to 1 ulp: the jitted JAX sum contracts into FMAs),
  ``_implicit_vertical_solve`` equal to the JAX function run eagerly.
- ``layered_tendencies`` and 1 and 3 steps of the port's plain path, built from the
  JAX model's own arrays (``layered_from_jax_arrays``), against the jitted JAX
  ``layered_step`` with ``use_pallas=True`` (interpret mode) and the per-group fill
  (``ROADMAP.md`` queue 3: the reference's serial fills are pinned against
  ``"per"``) at rtol 1e-12 / 1e-11 (``tests/test_layered_kernels.py:101, 121``).
- The 120 x 60 x 4 front oracle through the port's plain path with
  ``tests/test_parity.py:233-236``'s tolerances.

The gyre's options (closures, wind, drag, forcing) are tested in
``tests/test_torch_gyre.py``.
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
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (ROOT, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_model import jax_model_numpy  # noqa: E402

from examples.baroclinic_front_torch import build as torch_front  # noqa: E402
from examples.baroclinic_front_torch import kinetic_energy  # noqa: E402
from orthogonalsphericalshellgrids_tpu.grids.tripolar import (  # noqa: E402
    TripolarGrid as JaxGrid)
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models.split_explicit import (  # noqa: E402
    SplitExplicitFreeSurface as JaxFS)
from orthogonalsphericalshellgrids_tpu.ops.location import CC, CF, FC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_adv import tracer_adv_pallas  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_mom import momentum_pallas  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.pallas_vert import (  # noqa: E402
    pack_vert_statics, vertical_pallas)
from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import (  # noqa: E402
    momentum, tracer_adv, vertical)
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.ops import advection, operators  # noqa: E402

torch.set_num_threads(1)

DATA = os.path.join(ROOT, "tests", "data")
LAM_P, PHI_P = 45.0, 25.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close(got, want, rtol, sl=(slice(None),), name=""):
    got, want = np.asarray(got)[sl], np.asarray(want)[sl]
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=name)


# ----------------------------------------------------------------------------------
# plain kernel versions against the JAX Pallas kernels (interpret mode)
# ----------------------------------------------------------------------------------

def _vert_inputs(nz, n_tr, Yb, Xb, seed):
    """Random masked velocities, tracers, masks, metric planes and stretched layers
    (``tests/test_pallas_vert.py:_mk``'s construction)."""
    r = np.random.default_rng(seed)
    mc, mu, mv = (r.random((3, nz, Yb, Xb)) > 0.2).astype(np.float64)
    u = r.standard_normal((nz, Yb, Xb)) * mu
    v = r.standard_normal((nz, Yb, Xb)) * mv
    c = r.standard_normal((n_tr * nz, Yb, Xb))
    g = 0.5 + r.random((5, Yb, Xb))  # inv_az, inv_dx, inv_dy, dy_fc, dx_cf
    dz = tuple(50.0 * 1.5 ** k for k in range(nz))
    dzc = tuple(0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1))
    return u, v, c, mc, mu, mv, g, dz, dzc


VERT_CASES = [("none", False), ("none", True), ("tracer_b", False), ("tracer_b", True),
              ("linear_eos", False), ("linear_eos", True)]


@pytest.mark.parametrize("mode,mixing", VERT_CASES)
def test_vertical_plain_matches_pallas(mode, mixing):
    """S = 3 with explicit ν_v and κ_v (``mixing``), S = 1 without."""
    nz, Yb, Xb = 3, 40, 60
    n_tr = 2  # tracer_b: block 0 is c, block 1 is b; linear_eos: T and S
    u, v, c, mc, mu, mv, g, dz, dzc = _vert_inputs(nz, n_tr, Yb, Xb, seed=len(mode))
    if mode == "linear_eos":
        c[:nz] = 10.0 + c[:nz]
        c[nz:] = 35.0 + 0.1 * c[nz:]
    nu_v, kappa_v = (1e-3, 1e-5) if mixing else (0.0, 0.0)
    eos = (9.81, 1.67e-4, 7.8e-4, 10.0, 35.0)
    spack = pack_vert_statics(*(jnp.asarray(m) for m in ((mc, mu, mv) if mixing else (mc,))))
    want = vertical_pallas(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(c), spack, jnp.asarray(g), dz=dz,
        dzc=dzc, mode=mode, g_b=eos[0], alpha=eos[1], beta=eos[2], T0=eos[3], S0=eos[4],
        it_T=0 if mode == "linear_eos" else -1, it_S=1 if mode == "linear_eos" else -1,
        it_B=1 if mode == "tracer_b" else -1, nu_v=nu_v, kappa_v=kappa_v, interpret=True)
    tb = mode == "tracer_b"
    got = vertical.vertical(
        _t(u), _t(v), _t(c[:nz] if tb else c), _t(c[nz:]) if tb else None, _t(spack),
        _t(g), _t(vertical.coefficients(dz, dzc, nu_v, kappa_v)), mode=mode, eos=eos,
        it_T=0 if mode == "linear_eos" else -1, it_S=1 if mode == "linear_eos" else -1,
        viscous=mixing, diffusive=mixing)
    I = (slice(None), slice(1, -1), slice(1, -1))
    for name, a, w in zip(("dGu", "dGv", "dGc"), got, want):
        _assert_close(a.numpy(), w, 1e-12, I, name)


@pytest.mark.parametrize("mode", ["none", "tracer_b", "linear_eos"])
def test_vertical_plain_matches_xla_operators(mode):
    """``vertical_plain`` against the port's XLA-style formulation of the same terms
    (``vertical_velocity``'s cumulative sum, ``_w_advect``, ``_vertical_laplacian``,
    ``_hydrostatic_pressure``, ``_linear_eos_buoyancy``, ``_vertical_tracer_div``):
    the kernel order reassociates the layer sums, so a 1e-12 band."""
    nz, Yb, Xb = 4, 36, 52
    u, v, c, mc, mu, mv, g, dz, dzc = _vert_inputs(nz, 2, Yb, Xb, seed=11)
    eos = (9.81, 1.67e-4, 7.8e-4, 10.0, 35.0)
    names = ("T", "S") if mode == "linear_eos" else ("c",)
    n_c = len(names)
    cc = c[: n_c * nz]
    b = c[n_c * nz:] if mode == "tracer_b" else None
    model = _OperatorModel(mc, mu, mv, g, dz, dzc, names, eos)
    spack = np.stack([mc, mu, mv], axis=1).reshape(3 * nz, Yb, Xb)
    got = vertical.vertical(_t(u), _t(v), _t(cc), None if b is None else _t(b),
                            _t(spack), _t(g), _t(vertical.coefficients(dz, dzc, 1e-3, 1e-5)),
                            mode=mode, eos=eos, it_T=0 if n_c == 2 else -1,
                            it_S=1 if n_c == 2 else -1, viscous=True, diffusive=True)
    u, v, cc, mc3, mu3, mv3 = (_t(a) for a in (u, v, cc, mc, mu, mv))
    dz3, dzc3 = model.dz3, model.dzc3
    w = TL.vertical_velocity(model, u, v)
    dgu = -TL._w_advect(operators.ixf(w), u, dzc3) + 1e-3 * TL._vertical_laplacian(
        u, dz3, dzc3, mu3)
    dgv = -TL._w_advect(operators.iyf(w), v, dzc3) + 1e-3 * TL._vertical_laplacian(
        v, dz3, dzc3, mv3)
    if mode != "none":
        bb = TL._linear_eos_buoyancy(model, cc) if mode == "linear_eos" else _t(b)
        p = TL._hydrostatic_pressure(bb, dz3)
        dgu = dgu - operators.dxf(p) * model.inv_dx_fc
        dgv = dgv - operators.dyf(p) * model.inv_dy_cf
    blocks = [cc[k * nz:(k + 1) * nz] for k in range(n_c)] + ([_t(b)] if b is not None else [])
    dgc = torch.cat([(TL._vertical_tracer_div(w, q, dz3)
                      + 1e-5 * TL._vertical_laplacian(q, dz3, dzc3, mc3)) * mc3
                     for q in blocks])
    I = (slice(None), slice(1, -1), slice(1, -1))
    for name, a, want in zip(("dGu", "dGv", "dGc"), got, (dgu, dgv, dgc)):
        _assert_close(a.numpy(), want.numpy(), 1e-12, I, name)


class _OperatorModel:
    """The fields of a ``LayeredModel`` that the XLA-style operators read, from the
    random planes of ``_vert_inputs`` (``dy_fc``, ``dx_cf`` and ``1/az`` on a stub
    grid)."""

    def __init__(self, mc, mu, mv, g, dz, dzc, names, eos):
        self.nz = mc.shape[0]
        self.tracer_names = names
        self.g_b, self.alpha_T, self.beta_S, self.T0, self.S0 = eos
        self.mask_c3 = _t(mc)
        self.dz3 = torch.tensor(dz, dtype=torch.float64).view(-1, 1, 1)
        self.dzc3 = torch.tensor(dzc, dtype=torch.float64).view(-1, 1, 1)
        self.dzu = self.dz3 * _t(mu)
        self.dzv = self.dz3 * _t(mv)
        iaz, self.inv_dx_fc, self.inv_dy_cf, dy_fc, dx_cf = _t(g)
        self.grid = type("StubGrid", (), dict(az_cc=1.0 / iaz, dy_fc=dy_fc, dx_cf=dx_cf))


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-6), ("float64", 1e-12)])
def test_layered_momentum_plain_matches_pallas(dtype, rtol):
    nz, Yb, Xb = 3, 44, 60
    r = np.random.default_rng(5)
    u, v = r.standard_normal((2, nz, Yb, Xb)).astype(dtype)
    static = (1.0 + r.random((8, Yb, Xb))).astype(dtype)
    static[3] = 0.1 * r.standard_normal((Yb, Xb))  # f_ff
    want = momentum_pallas(jnp.asarray(u), jnp.asarray(v), jnp.asarray(static), None,
                           interpret=True)
    got = momentum.momentum(_t(u), _t(v), _t(static), has_mask=False)
    R = momentum.REACH
    for name, a, w in zip(("Gu", "Gv"), got, want):
        _assert_close(a.numpy(), w, rtol, (slice(None), slice(R, -R), slice(R, -R)), name)


@pytest.mark.parametrize("n_tr", [1, 2])
def test_layered_tracer_adv_plain_matches_pallas(n_tr):
    nz, Yb, Xb = 3, 44, 60
    r = np.random.default_rng(n_tr)
    mask = (r.random((nz, Yb, Xb)) > 0.2).astype(np.float64)
    u = r.standard_normal((nz, Yb, Xb)) * mask  # masked, as the layered mode needs
    v = r.standard_normal((nz, Yb, Xb)) * mask
    c = r.standard_normal((n_tr * nz, Yb, Xb))
    iv = mask * (0.5 + r.random((nz, Yb, Xb)))
    g = 0.5 + r.random((2, Yb, Xb))
    dz = (50.0, 120.0, 300.0)
    want = tracer_adv_pallas(jnp.asarray(c), jnp.asarray(u), jnp.asarray(v),
                             statics_packed=jnp.asarray(iv), g_pack=jnp.asarray(g), dz=dz,
                             interpret=True)
    got = tracer_adv.tracer_adv(_t(c), _t(u), _t(v), _t(iv), _t(g), torch.tensor(dz, dtype=torch.float64))
    R = tracer_adv.REACH
    _assert_close(got.numpy(), want, 1e-12, (slice(None), slice(R, -R), slice(R, -R)))


def test_layered_wrappers_reject_bad_operands():
    nz, Yb, Xb = 3, 20, 24
    z = torch.zeros((nz, Yb, Xb), dtype=torch.float64)
    g2 = torch.zeros((2, Yb, Xb), dtype=torch.float64)
    dz = torch.ones(nz, dtype=torch.float64)
    with pytest.raises(ValueError):  # a pack of S = 3 per layer is refused, not misread
        tracer_adv.tracer_adv(z, z, z, torch.zeros((3 * nz, Yb, Xb), dtype=torch.float64),
                              g2, dz)
    with pytest.raises(ValueError):  # layered mode needs both g_pack and dz
        tracer_adv.tracer_adv(z, z, z, z, g2)
    with pytest.raises(ValueError):  # the layered momentum pack has no masks
        momentum.momentum(z, z, torch.zeros((10, Yb, Xb), dtype=torch.float64),
                          has_mask=False)
    g5 = torch.zeros((5, Yb, Xb), dtype=torch.float64)
    coef = torch.zeros((5, nz), dtype=torch.float64)
    with pytest.raises(ValueError):  # explicit ν_v needs S = 3
        vertical.vertical(z, z, z, None, z, g5, coef, viscous=True)
    with pytest.raises(ValueError):  # tracer_b takes b
        vertical.vertical(z, z, z, None, z, g5, coef, mode="tracer_b")
    with pytest.raises(TypeError):
        vertical.vertical(z.float(), z, z, None, z, g5, coef)


@pytest.mark.parametrize("name", ["dxc", "dxf", "dyc", "dyf", "ixc", "ixf", "iyc", "iyf",
                                  "weno_faces_x", "weno_centers_y"])
def test_operators_broadcast_over_layers(name):
    """The ops roll along axes -1/-2 only, so on an (Nz, Yb, Xb) stack they equal
    the same op layer by layer, bitwise."""
    r = np.random.default_rng(3)
    q, vel = _t(r.standard_normal((2, 3, 20, 24)))
    if name == "weno_faces_x":
        def op(a, w):
            return advection.weno5_upwind_faces_from_centers(a, w, axis=-1)
    elif name == "weno_centers_y":
        def op(a, w):
            return advection.weno5_upwind_centers_from_faces(a, w, axis=-2)
    else:
        def op(a, w):
            return getattr(operators, name)(a)
    got = op(q, vel)
    for k in range(q.shape[0]):
        assert torch.equal(got[k], op(q[k], vel[k]))


# ----------------------------------------------------------------------------------
# model construction and the implicit solve
# ----------------------------------------------------------------------------------

def bottom(lam, phi):
    land = (((np.abs(lam - LAM_P) < 10) & (np.abs(PHI_P - phi) < 10))
            | ((np.abs(lam - (LAM_P + 180.0)) < 10) & (np.abs(PHI_P - phi) < 10))
            | (phi < -78))
    return np.where(land, 1.0, np.where(phi > 40, -600.0, -1000.0))


CONFIGS = {
    # the baroclinic front's options: prognostic b, one tracer, explicit ν_v, κ_v
    "front": dict(buoyancy=True, coriolis=True, nu_v=1e-4, kappa_v=1e-5),
    "linear_eos": dict(buoyancy="linear_eos", tracers=("T", "S"), coriolis=True,
                       nu_v=1e-3, kappa_v=1e-5),
    "implicit": dict(buoyancy=True, tracers=("c", "d"), coriolis=True, nu_v=5e-2,
                     kappa_v=1e-2, vertical_time_discretization="implicit"),
}


def _init_fns(cfg):
    names = cfg.get("tracers", ("c",))
    c = {n: (lambda lam, phi, z, a=i: np.sin(np.deg2rad(phi) * (4 + a)) * np.exp(z / 600.0))
         for i, n in enumerate(names)}
    if cfg.get("buoyancy") == "linear_eos":
        c = {"T": lambda lam, phi, z: 4.0 + 16.0 * np.cos(np.deg2rad(phi)) ** 2
             * np.exp(z / 500.0),
             "S": lambda lam, phi, z: 34.0 + 1.5 * np.cos(np.deg2rad(phi)) ** 2
             * np.exp(z / 800.0)}
    return dict(
        u=lambda lam, phi, z: 0.3 / np.cosh(np.deg2rad(phi) * 8) ** 2 * np.exp(z / 400.0),
        v=lambda lam, phi, z: 0.05 * np.sin(np.deg2rad(lam) * 3),
        c=c, b=lambda lam, phi, z: 1e-5 * z + 1e-3 * np.tanh((phi - 10.0) / 8.0),
        eta=lambda lam, phi: 0.01 * np.cos(np.deg2rad(lam) * 2))


def _grid_args(nz):
    return dict(size=(48, 32, nz), halo=(5, 5, 5), z=(-1000.0, 0.0),
                first_pole_longitude=LAM_P, north_poles_latitude=PHI_P)


def _jax_model(cfg, nz=3):
    a = _grid_args(nz)
    grid = JaxGrid.make(a.pop("size"), dtype=jnp.float64, **a)
    m = JL.make_layered_model(grid, free_surface=JaxFS(substeps=6), bottom_height=bottom,
                              use_pallas=True, **cfg)
    return m, JL.layered_initial_state(m, **_init_fns(cfg))


def _torch_model(cfg, nz=3):
    a = _grid_args(nz)
    grid = TripolarGrid.make(a.pop("size"), dtype=torch.float64, device="cpu", **a)
    m = TL.make_layered_model(grid, free_surface=SplitExplicitFreeSurface(substeps=6),
                              bottom_height=bottom, device="cpu", **cfg)
    return m, TL.layered_initial_state(m, **_init_fns(cfg))


def jax_layered_numpy(jm):
    """(arrays, meta) of a JAX LayeredModel in ``layered_from_jax_arrays``'s layout."""
    base, base_meta = jax_model_numpy(jm.baro)
    arrays = {"baro": base, "mom_lay": None if jm.mom_lay is None else np.asarray(jm.mom_lay)}
    arrays.update({n: np.asarray(getattr(jm, n)) for n in TL.BUFFERS})
    meta = {n: getattr(jm, n) for n in TL.META}
    meta["baro"] = base_meta
    return arrays, meta


def _state_numpy(s):
    return {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_make_layered_model_and_initial_state_exact(config):
    jm, js = _jax_model(CONFIGS[config])
    tm, ts = _torch_model(CONFIGS[config])
    for name in TL.BUFFERS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in TL.META:
        assert getattr(tm, name) == getattr(jm, name), name
    assert jm.mom_lay is None
    for name, want in _state_numpy(js).items():
        if name in ("U", "V"):
            # Σ u·dzu: the jitted JAX assembly fuses the product into the reduction,
            # where XLA:CPU may contract it into an FMA; 1 ulp apart
            _assert_close(getattr(ts, name).numpy(), want, 1e-15, name=name)
        else:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), want, err_msg=name)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_implicit_vertical_solve_matches_jax_eager(lead):
    nz, Y, X = 4, 12, 16
    r = np.random.default_rng(4)
    q = r.standard_normal(lead + (nz, Y, X))
    mask = (r.random((nz, Y, X)) > 0.25).astype(np.float64)
    dz = (40.0, 90.0, 200.0, 400.0)
    dzc = tuple(0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1))
    rr = 120.0 * 7e-2
    with jax.disable_jit():
        want = JL._implicit_vertical_solve(jnp.asarray(q), jnp.asarray(rr), dz, dzc,
                                           jnp.asarray(mask))
    got = TL._implicit_vertical_solve(_t(q), torch.tensor(rr, dtype=torch.float64), dz, dzc, _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------------------
# tendencies and steps through layered_from_jax_arrays
# ----------------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request):
    """A config's JAX model and state, the port's model and state built from their
    leaves, and the JAX states after 1 and 3 steps (jitted, kernels in interpret
    mode, per-group fill)."""
    jm, js = _jax_model(CONFIGS[request.param])
    arrays, meta = jax_layered_numpy(jm)
    tm = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    ts = TL.layered_state_from_numpy(_state_numpy(js), device="cpu")
    step = jax.jit(lambda m, s: JL.layered_step(m, s, 90.0, fill_mode="per"))
    out, s = {}, js
    for n in range(1, 4):
        s = step(jm, s)
        out[n] = s
    return dict(jm=jm, js=js, tm=tm, ts=ts, jout=out)


def test_layered_tendencies_match_jax(run):
    """The port's tendencies of the initial state against the JAX step's own (the
    first step's returned Gu, Gv, Gc, Gb; Gb stays 0 without a prognostic b)."""
    jm, js, tm = run["jm"], run["js"], run["tm"]
    want = (run["jout"][1].Gu, run["jout"][1].Gv, run["jout"][1].Gc, run["jout"][1].Gb)
    u = JL._fill3(jm, js.u, FC, -1)
    v = JL._fill3(jm, js.v, CF, -1)
    c = JL._fill3(jm, js.c, CC, 1)
    b = JL._fill3(jm, js.b, CC, 1) if jm.has_b else js.b
    got = TL.layered_tendencies(tm, *(_t(a) for a in (u, v, c, b)))
    I3 = (slice(None),) + jm.grid.interior2d
    for name, a, w in zip(("Gu", "Gv", "Gc", "Gb"), got, want):
        _assert_close(a.numpy(), w, 1e-12, I3, name)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_layered_step_matches_jax(run, n_steps):
    jm, tm, ts = run["jm"], run["tm"], run["ts"]
    jout = run["jout"][n_steps]
    before = {k: v.clone() for k, v in dataclasses.asdict(ts).items()}
    kernels.reset_launch_counts()
    tout = TL.layered_multi_step(tm, ts, 90.0, n_steps)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}  # plain path
    g, ge = jm.grid, jm.grid_ext
    I3 = (slice(None),) + g.interior2d
    for name in ("u", "v", "c", "b", "Gu", "Gv", "Gc", "Gb"):
        _assert_close(getattr(tout, name).numpy(), getattr(jout, name), 1e-11, I3, name)
    for name in ("eta", "U", "V"):
        _assert_close(getattr(tout, name).numpy(), getattr(jout, name), 1e-11,
                      ge.interior2d, name)
    assert float(tout.t) == pytest.approx(float(jout.t), rel=1e-15)
    assert int(tout.iteration) == int(jout.iteration)
    for k, v in before.items():
        assert torch.equal(getattr(ts, k), v), f"step mutated state.{k}"


def test_layered_cfl_dt_matches_jax(run):
    jm, js, tm, ts = run["jm"], run["js"], run["tm"], run["ts"]
    assert float(TL.layered_cfl_dt(tm, ts)) == pytest.approx(
        float(JL.layered_cfl_dt(jm, js)), rel=1e-14)


# ----------------------------------------------------------------------------------
# the front oracle
# ----------------------------------------------------------------------------------

def test_front_oracle_through_port():
    """15 steps of the 120 x 60 x 4 float64 front through the port's plain path
    reproduce the committed layered oracle (``tests/test_parity.py:205-236``)."""
    with np.load(os.path.join(DATA, "front_oracle_120x60x4.npz")) as data:
        nx, ny, nz, dt, _, _ = data["meta"]
        u15, v15, b15 = data["u.015"], data["v.015"], data["b.015"]
        ke_ref = data["ke"][:15]
    model, s = torch_front(int(nx), int(ny), int(nz), dtype=torch.float64, device="cpu")
    ke = []
    for _ in range(15):
        s = TL.layered_step(model, s, float(dt))
        ke.append(kinetic_energy(model, s))
    I3 = (slice(None),) + model.grid.interior2d
    np.testing.assert_allclose(s.u.numpy()[I3], u15, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(s.v.numpy()[I3], v15, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(s.b.numpy()[I3], b15, rtol=1e-9, atol=1e-14)
    np.testing.assert_allclose(ke, ke_ref, rtol=1e-10)
