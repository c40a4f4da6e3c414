"""Ensembles of the PyTorch port's layered model (``models/ensemble.py`` on a
``LayeredModel``).

- ``ensemble_multi_step`` against the jitted ``jax.vmap`` of two JAX ``layered_step``s
  (``fill_mode="per"``, kernels in interpret mode: ``ROADMAP.md`` queue 3 pins the
  reference's serial fills against ``"per"``) for the three ``CONFIGS`` of
  ``tests/test_torch_layered.py`` (front, linear_eos, implicit) at 48 x 32 x 3,
  float64, substeps 6, members scaled 0.5, 1.0 and 1.5: rtol 1e-11 on the interior,
  the band of ``test_layered_step_matches_jax`` (XLA:CPU contracts multiply-adds where
  eager PyTorch does not).
- The port's ensemble against member-wise serial stepping, bitwise, with the members
  at different iterations (so that each member's AB2 weights show): the gyre's
  options (wind, quadratic drag, ν_h, κ_h) with forcing that reads t, the front's
  prognostic b, the implicit vertical solve, the biharmonic closures with linear
  drag (no fold), and the plain tracer scheme and centered momentum.
- The member versions of the four kernels' plain paths (through their wrappers on
  the CPU) against B single calls, bitwise: ``vertical``, ``corrector`` (per-member
  weights), ``momentum`` with a period (layered and single-layer members) and the
  layered ``tracer_adv`` over members (``acc`` a view, as the c block of a dGc stack
  that also holds b).
- The refusals: a dt per member, a state of the other kind.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (ROOT, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_layered import (CONFIGS, _assert_close, _jax_model,  # noqa: E402
                                _state_numpy, _torch_model, jax_layered_numpy)

from examples import wind_driven_ts_gyre_torch as gyre  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import (  # noqa: E402
    corrector, momentum, tracer_adv, vertical)
from orthogonalsphericalshellgrids_tpu_torch.models import ensemble  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402

torch.set_num_threads(1)

SCALES = (0.5, 1.0, 1.5)
STATE = [f.name for f in dataclasses.fields(TL.LayeredState)]


def _scaled(state, s):
    """The state with every field times ``s`` (t and iteration kept), as
    ``tests/test_ensemble.py`` makes its members."""
    return TL.LayeredState(**{n: getattr(state, n) * s if n not in ("t", "iteration")
                              else getattr(state, n) for n in STATE})


# ----------------------------------------------------------------------------------
# against jax.vmap of the JAX layered step
# ----------------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(CONFIGS))
def vmapped(request):
    """A config's JAX model and the jitted ``jax.vmap`` of two of its steps on the
    three scaled members, and the port's ensemble of the same members two steps on
    (the port's model and state built from the JAX leaves)."""
    jm, js = _jax_model(CONFIGS[request.param])
    scales = jax.numpy.asarray(SCALES, jax.numpy.float64)

    def scaled(s):
        return jax.tree.map(lambda a: (a * s).astype(a.dtype), js)

    def step2(st):
        st = JL.layered_step(jm, st, 90.0, fill_mode="per")
        return JL.layered_step(jm, st, 90.0, fill_mode="per")

    jout = jax.jit(jax.vmap(step2))(jax.vmap(scaled)(scales))
    arrays, meta = jax_layered_numpy(jm)
    tm = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    ts = TL.layered_state_from_numpy(_state_numpy(js), device="cpu")
    batch = ensemble.stack_members([_scaled(ts, s) for s in SCALES])
    kernels.reset_launch_counts()
    tout = ensemble.ensemble_multi_step(tm, batch, 90.0, 2)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}  # plain path
    return dict(jm=jm, jout=jout, tout=tout)


@pytest.mark.parametrize("i", range(len(SCALES)))
def test_layered_ensemble_matches_jax_vmap(vmapped, i):
    """Member ``i`` of the port's ensemble against member ``i`` of the JAX vmap, two
    steps of 90 s, every field at rtol 1e-11 on the interior."""
    jm = vmapped["jm"]
    want = jax.tree.map(lambda a: a[i], vmapped["jout"])
    got = ensemble.member(vmapped["tout"], i)
    g, ge = jm.grid, jm.grid_ext
    I3 = (slice(None),) + g.interior2d
    for name in ("u", "v", "c", "b", "Gu", "Gv", "Gc", "Gb"):
        _assert_close(getattr(got, name).numpy(), getattr(want, name), 1e-11, I3, name)
    for name in ("eta", "U", "V"):
        _assert_close(getattr(got, name).numpy(), getattr(want, name), 1e-11,
                      ge.interior2d, name)
    assert float(got.t) == pytest.approx(float(want.t), rel=1e-15)
    assert int(got.iteration) == int(want.iteration) == 2


# ----------------------------------------------------------------------------------
# bitwise against member-wise serial stepping
# ----------------------------------------------------------------------------------

def _heat_T(lam, phi, z, t, f):
    return 1e-7 * (1.0 + 1e-4 * t) * (z / 1000.0) * (phi * 0.0 + 1.0)


def _relax_u(lam, phi, z, t, f):
    return -1e-5 * f.u * (1.0 + 1e-5 * t)


def _warm_b(lam, phi, z, t, f):
    return 1e-9 * torch.sin(2e-4 * t) * torch.cos(torch.deg2rad(phi)) * (z * 0.0 + 1.0)


OPTIONS = {
    # the gyre's options and forcing that reads t
    "gyre_forcing": dict(gyre.CHECK_OPTIONS, forcing={"T": _heat_T, "u": _relax_u}),
    # the front's prognostic b with its own forcing
    "front_forcing": dict(CONFIGS["front"], forcing={"b": _warm_b}),
    "implicit": dict(CONFIGS["implicit"]),
    # no fold: ν4_h and linear drag follow the kernel; κ4_h follows the tracer kernel
    "biharmonic_linear": dict(gyre.CHECK_OPTIONS, nu_h=0.0, kappa_h=0.0, nu4_h=1e17,
                              kappa4_h=1e17, bottom_drag=("linear", 2e-4)),
    # the tracer faces and the vorticity in plain PyTorch, two tracers and b
    "schemes": dict(buoyancy=True, tracers=("c", "d"), coriolis=True, nu_v=1e-3,
                    kappa_v=1e-5, tracer_advection="upwind3",
                    momentum_advection="vector_invariant", wind_stress=gyre.check_wind),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_layered_ensemble_is_member_wise_serial_bitwise(option):
    """Three members, the second one step ahead (iteration 1, so its first ensemble
    step is AB2 while the others' is forward Euler), three steps: every field of every
    member bitwise its own serial steps, the batch unchanged, ``layered_cfl_dt`` per
    member."""
    model, base = _torch_model(OPTIONS[option])
    serial = [_scaled(base, s) for s in SCALES]
    serial[1] = TL.layered_step(model, serial[1], 60.0)
    batch = ensemble.stack_members(serial)
    assert batch.u.shape == (3,) + base.u.shape and batch.t.shape == (3,)
    kept = {n: getattr(batch, n).clone() for n in STATE}
    out = ensemble.ensemble_multi_step(model, batch, 60.0, 3)
    for n, a in kept.items():
        assert torch.equal(getattr(batch, n), a), n
    assert out.iteration.tolist() == [3, 4, 3]
    cfl = ensemble.layered_cfl_dt(model, out)
    assert cfl.shape == (3,)
    for i, s in enumerate(serial):
        want = TL.layered_multi_step(model, s, 60.0, 3)
        got = ensemble.member(out, i)
        for n in STATE:
            assert torch.equal(getattr(got, n), getattr(want, n)), (i, n)
        assert torch.equal(cfl[i], TL.layered_cfl_dt(model, want))


def test_layered_member_round_trip():
    """``member`` gives back the layered states ``stack_members`` took; states of two
    kinds are refused."""
    model, base = _torch_model(CONFIGS["front"])
    states = [_scaled(base, s) for s in SCALES]
    batch = ensemble.stack_members(states)
    assert isinstance(batch, TL.LayeredState)
    for i, s in enumerate(states):
        back = ensemble.member(batch, i)
        assert isinstance(back, TL.LayeredState)
        for n in STATE:
            assert torch.equal(getattr(back, n), getattr(s, n))
    from examples.bickley_jet_torch import build as torch_build
    _, single = torch_build(32, 24, dtype=torch.float64, substeps=6, device="cpu")
    with pytest.raises(ValueError, match="one kind"):
        ensemble.stack_members([base, single])


def test_layered_refusals():
    """A dt per member and a single-layer batch are refused (sharded layered
    ensembles are ``tests/test_torch_sharded_ensemble.py``'s)."""
    model, base = _torch_model(CONFIGS["linear_eos"])
    batch = ensemble.stack_members([base, base])
    with pytest.raises(ValueError, match="one dt"):
        ensemble.ensemble_step(model, batch, torch.tensor([60.0, 30.0],
                                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="one dt"):
        ensemble.ensemble_multi_step(model, batch, torch.tensor([60.0, 30.0],
                                                                dtype=torch.float64), 2)
    from examples.bickley_jet_torch import build as torch_build
    _, single = torch_build(32, 24, dtype=torch.float64, substeps=6, device="cpu")
    with pytest.raises(TypeError):
        ensemble.ensemble_step(model, ensemble.stack_members([single, single]), 60.0)


# ----------------------------------------------------------------------------------
# the member versions of the plain kernels against B single calls
# ----------------------------------------------------------------------------------

B, NZ, YB, XB = 3, 4, 23, 37


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("mode", sorted(vertical.MODES))
@pytest.mark.parametrize("mixing", [False, True])
def test_vertical_members_plain_bitwise(mode, mixing):
    """The vertical terms of B members (their own u, v, c, b; shared counts, metric
    planes and coefficients) are the single calls', bit for bit."""
    r = np.random.default_rng(len(mode) + 10 * mixing)
    n_wet = torch.as_tensor(np.minimum(r.integers(0, NZ + 3, (YB, XB)), NZ).astype(np.int32))
    n_c = 2 if mode == "linear_eos" else 1
    u, v = (_t(r.standard_normal((B, NZ, YB, XB))) for _ in range(2))
    c = r.standard_normal((B, n_c * NZ, YB, XB))
    if mode == "linear_eos":
        c[:, :NZ] += 10.0
        c[:, NZ:] = 35.0 + 0.1 * c[:, NZ:]
    c = _t(c)
    b = _t(r.standard_normal((B, NZ, YB, XB))) if mode == "tracer_b" else None
    g = _t(0.5 + r.random((5, YB, XB)))
    dz = [50.0 * 1.07 ** k for k in range(NZ)]
    coef = _t(vertical.coefficients(dz, [0.5 * (dz[k] + dz[k + 1]) for k in range(NZ - 1)],
                                    1e-3 if mixing else 0.0, 1e-5 if mixing else 0.0))
    kw = dict(mode=mode, eos=(9.81, 1.67e-4, 7.8e-4, 10.0, 35.0),
              it_T=0 if n_c == 2 else -1, it_S=1 if n_c == 2 else -1, viscous=mixing,
              diffusive=mixing)
    got = vertical.vertical(u, v, c, b, n_wet, g, coef, **kw)
    assert [tuple(a.shape) for a in got] == [(B, NZ, YB, XB)] * 2 + [
        (B, (n_c + (b is not None)) * NZ, YB, XB)]
    for m in range(B):
        one = vertical.vertical(u[m], v[m], c[m], None if b is None else b[m], n_wet, g,
                                coef, **kw)
        for a, o in zip(got, one):
            assert torch.equal(a[m], o)
    with pytest.raises(ValueError, match="like u"):
        vertical.vertical(u, v, c[0], b, n_wet, g, coef, **kw)


@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("per_member_dt", [False, True])
def test_corrector_members_plain_bitwise(with_b, per_member_dt):
    """The corrector of B members, each with its own w1, w2 (one member at its first
    step) and its own crop of the widened U_a, V_a, is the single calls', bit for bit;
    the thicknesses, masks and inverse depths are shared."""
    r = np.random.default_rng(3 + with_b + 2 * per_member_dt)
    n_c = 2 * NZ
    stacks = [_t(r.standard_normal((B, NZ, YB, XB))) for _ in range(6)]
    tracers = [_t(r.standard_normal((B, n_c, YB, XB))) for _ in range(3)]
    masks = [_t(r.random((NZ, YB, XB)) > 0.2) for _ in range(3)]
    dz3 = _t(np.linspace(10.0, 400.0, NZ)).view(-1, 1, 1)
    ext = _t(r.standard_normal((2, B, YB + 10, XB + 14)))
    U_a, V_a = ext[0, :, 5:5 + YB, 7:7 + XB], ext[1, :, 5:5 + YB, 7:7 + XB]
    w1, w2 = _t([1.0, 1.6, 1.6]), _t([0.0, 0.6, 0.6])
    dt = _t([40.0, 40.0, 20.0]) if per_member_dt else _t(40.0)
    shared = (dz3 * masks[0], dz3 * masks[1], masks[2], _t(r.random((YB, XB))),
              _t(r.random((YB, XB))))
    bb = tuple(_t(r.standard_normal((B, NZ, YB, XB))) for _ in range(3)) if with_b else None
    got = corrector.corrector(*stacks, *tracers, *shared, U_a, V_a, w1, w2, dt, b=bb)
    for m in range(B):
        one = corrector.corrector(*(s[m] for s in stacks), *(t[m] for t in tracers),
                                  *shared, U_a[m], V_a[m], w1[m], w2[m],
                                  dt[m] if per_member_dt else dt,
                                  b=None if bb is None else tuple(x[m] for x in bb))
        for a, o in zip(got, one):
            assert (a is None and o is None) or torch.equal(a[m], o)
    with pytest.raises(ValueError, match="one per"):
        corrector.corrector(*stacks, *tracers, *shared, U_a, V_a, w1[:2], w2[:2], dt,
                            b=bb)


@pytest.mark.parametrize("case", ["layered_closures", "layered_operands", "single_layer"])
def test_momentum_period_plain_bitwise(case):
    """The momentum of B members as layers with a period: B layered members of Nz
    layers (period Nz; the closure pack and the closing mask of one member, acc per
    layer), or B single-layer members (period 1, the masked layer's closure pack);
    each member's layers are its single call's, bit for bit."""
    r = np.random.default_rng(len(case))
    single = case == "single_layer"
    nz = 1 if single else NZ
    per = (nz, YB, XB)
    u, v = (_t(r.standard_normal((B * nz, YB, XB))) for _ in range(2))
    static = 1.0 + r.random((10 if single else 8, YB, XB))
    static[3] = 0.1 * r.standard_normal((YB, XB))
    if single:
        static[8:] = r.random((2, YB, XB)) > 0.15
    kw = dict(has_mask=single)
    if case != "layered_operands":
        lay = 0.5 + r.random((nz, 8, YB, XB))
        lay[:, 6:] *= 0.1
        kw.update(lay=_t(lay.reshape(-1, YB, XB)), has_lap=True, has_drag=True)
    out = None
    if not single:
        out = tuple(_t(r.random(per) > 0.2) for _ in range(2))
        kw["mask_out"] = out
    acc = None if single else tuple(_t(0.5 * r.standard_normal(u.shape)) for _ in range(2))
    got = momentum.momentum(u, v, _t(static), acc=acc, period=nz, **kw)
    for m in range(B):
        lay_m = slice(m * nz, (m + 1) * nz)
        uu, vv = (u[m], v[m]) if single else (u[lay_m], v[lay_m])
        one = momentum.momentum(uu, vv, _t(static), acc=None if acc is None else
                                tuple(a[lay_m] for a in acc), **kw)
        for a, o in zip(got, one):
            assert torch.equal(a[m] if single else a[lay_m], o)
    with pytest.raises(ValueError, match="period"):
        momentum.momentum(u[:5], v[:5], _t(static), period=2, **dict(kw, mask_out=None))


@pytest.mark.parametrize("n_tr", [1, 2])
@pytest.mark.parametrize("kappa", [False, True])
@pytest.mark.parametrize("acc_kind", [None, "stack", "view"])
def test_tracer_layered_members_plain_bitwise(n_tr, kappa, acc_kind):
    """The layered tracer tendency of B members (each member's n_tr·Nz planes over its
    own u and v; one pack, metric planes and dz) is the single calls', bit for bit,
    with ``acc`` absent, a stack shaped like c, or a view of a larger stack (the c
    block of a dGc that also holds b)."""
    r = np.random.default_rng(n_tr + 2 * kappa + 5 * len(str(acc_kind)))
    mask = r.random((NZ, YB, XB)) > 0.2
    u, v = (_t(r.standard_normal((B, NZ, YB, XB)) * mask) for _ in range(2))
    c = r.standard_normal((B, n_tr * NZ, YB, XB))
    c[:, :, : YB // 3] = 0.0
    c = _t(c)
    S = 4 if kappa else 1
    pack = _t(((0.5 + r.random((NZ, S, YB, XB))) * mask[:, None]).reshape(NZ * S, YB, XB))
    g2, dz = _t(0.5 + r.random((2, YB, XB))), _t([50.0, 120.0, 300.0, 500.0])
    acc = None
    if acc_kind == "stack":
        acc = _t(0.5 * r.standard_normal(c.shape))
    elif acc_kind == "view":
        acc = _t(0.5 * r.standard_normal((B, (n_tr + 1) * NZ, YB, XB)))[:, :n_tr * NZ]
        assert not acc.is_contiguous()
    got = tracer_adv.tracer_adv(c, u, v, pack, g2, dz, acc=acc)
    assert got.shape == c.shape
    for m in range(B):
        one = tracer_adv.tracer_adv(c[m], u[m], v[m], pack, g2, dz,
                                    acc=None if acc is None else acc[m].contiguous())
        assert torch.equal(got[m], one)
    with pytest.raises(ValueError, match="members"):
        tracer_adv.tracer_adv(c[:2], u, v, pack, g2, dz)
    with pytest.raises(ValueError, match="pack"):
        tracer_adv.tracer_adv(c, u, v, pack[:-1], g2, dz)


def test_cpu_layered_ensemble_launches_nothing():
    """On the CPU every member path takes the plain versions: no launch is counted."""
    model, base = gyre.build_check(device="cpu")
    batch = ensemble.stack_members([base, _scaled(base, 0.5)])
    kernels.reset_launch_counts()
    out = ensemble.ensemble_step(model, batch, 60.0)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert all(bool(torch.isfinite(getattr(out, n)).all()) for n in ("u", "v", "c", "eta"))

