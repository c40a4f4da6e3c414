"""Ensembles of the PyTorch port's single-layer model (``models/ensemble.py``).

- ``ensemble_step`` against ``jax.vmap(step)`` of the JAX package
  (``tests/test_ensemble.py``) at float64, rtol 1e-12 on the interior (the band of
  ``tests/test_torch_model.py``: XLA:CPU contracts multiply-adds where eager PyTorch
  does not);
- the port's ensemble against member-wise serial stepping, bitwise, with members at
  different iterations (so that each member's AB2 weights show), several tracers and
  the options that run in plain PyTorch beside the kernels (closures, drag, forcing
  that reads t, another tracer scheme);
- the member axis of the plain barotropic subcycle and the plain tracer advection
  against B single calls, bitwise, and a replay of the barotropic kernel's member
  addressing (``tests/test_torch_baro_plan.py:replay``) against one-member replays;
- the refusal of a dt per member (ensembles of the layered model are
  ``tests/test_torch_layered_ensemble.py``'s, sharded ensembles
  ``tests/test_torch_sharded_ensemble.py``'s).
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

from test_model import bickley_model  # noqa: E402
from test_torch_baro_plan import _inputs as baro_inputs  # noqa: E402
from test_torch_baro_plan import replay as baro_replay  # noqa: E402
from test_torch_model import (_assert_states_close, jax_model_numpy,  # noqa: E402
                              jax_state_numpy)

from examples.bickley_jet_torch import bottom_height  # noqa: E402
from examples.bickley_jet_torch import build as torch_build  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import step as jax_step  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import barotropic, tracer_adv  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import ensemble  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (  # noqa: E402
    averaging_weights)

torch.set_num_threads(1)

SCALES = (0.5, 1.0, 1.5)


def _scaled(state, s):
    """The state with every field times ``s``, as ``tests/test_ensemble.py`` makes its
    members (t and iteration are 0 there, and kept here)."""
    return TH.State(**{f.name: getattr(state, f.name) * s
                       if f.name not in ("t", "iteration") else getattr(state, f.name)
                       for f in dataclasses.fields(TH.State)})


def test_ensemble_step_matches_jax_vmap():
    """Three members of the 32 x 24 Bickley jet (substeps 6), two steps of 90 s: the
    port's ensemble against the jitted ``jax.vmap`` of two JAX steps, member by
    member, at float64."""
    jm, base = bickley_model(size=(32, 24, 1), dtype=jnp.float64, substeps=6)
    scales = jnp.asarray(SCALES, jnp.float64)

    def member(s):
        return jax.tree.map(lambda a: (a * s).astype(a.dtype), base)

    step2 = lambda st: jax_step(jm, jax_step(jm, st, 90.0), 90.0)  # noqa: E731
    jout = jax.jit(jax.vmap(step2))(jax.vmap(member)(scales))

    arrays, meta = jax_model_numpy(jm)
    tm = TH.from_jax_arrays(arrays, meta, device="cpu")
    ts = TH.state_from_numpy(jax_state_numpy(base), device="cpu")
    batch = ensemble.stack_members([_scaled(ts, s) for s in SCALES])
    assert batch.u.shape == (3,) + ts.u.shape and batch.t.shape == (3,)
    tout = ensemble.ensemble_multi_step(tm, batch, 90.0, 2)
    for i in range(len(SCALES)):
        _assert_states_close(jm, jax.tree.map(lambda a: a[i], jout),
                             ensemble.member(tout, i), rtol=1e-12)


def _forcing_c(lam, phi, t, fields):
    return 1e-7 * torch.sin(2e-4 * t) * torch.cos(torch.deg2rad(phi))


def _forcing_d(lam, phi, t, fields):
    return -1e-5 * fields.c[..., 1, :, :]


OPTIONS = {
    "weno5": {},
    "closures": dict(nu_h=2e3, kappa_h=1e2, bottom_drag=("quadratic", 1e-3)),
    "upwind3_centered": dict(tracer_advection="upwind3",
                             momentum_advection="vector_invariant", nu4_h=1e9),
    "forcing": dict(forcing={"c": _forcing_c}, wind_stress=lambda lam, phi: (
        1e-4 * np.cos(np.deg2rad(phi)), 0.0 * phi), bottom_drag=("linear", 1e-4)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("n_tracers", [1, 2])
def test_ensemble_is_member_wise_serial_bitwise(option, n_tracers):
    """Three members, the second one step ahead (iteration 1, so its first ensemble
    step is AB2 while the others' is forward Euler), three steps: every field of
    every member bitwise its own serial steps; ``compute_cfl_dt`` per member."""
    kw = dict(OPTIONS[option])
    tracers = ("c",) if n_tracers == 1 else ("c", "d")
    if n_tracers > 1 and "forcing" in kw:
        kw["forcing"] = dict(kw["forcing"], d=_forcing_d)
    model0, base = torch_build(32, 24, dtype=torch.float64, substeps=6, device="cpu")
    model = TH.make_model(model0.grid, free_surface=SplitExplicitFreeSurface(substeps=6),
                          bottom_height=bottom_height(), tracers=tracers, device="cpu", **kw)
    if n_tracers > 1:
        c = torch.stack([base.c, base.c * base.c])
        base = dataclasses.replace(base, c=c, Gc=torch.zeros_like(c))
    serial = [_scaled(base, s) for s in SCALES]
    serial[1] = TH.step(model, serial[1], 60.0)
    batch = ensemble.stack_members(serial)
    kept = {f.name: getattr(batch, f.name).clone() for f in dataclasses.fields(batch)}
    out = ensemble.ensemble_multi_step(model, batch, 60.0, 3)
    for name, a in kept.items():  # the batch is as it was
        assert torch.equal(getattr(batch, name), a), name
    assert out.iteration.tolist() == [3, 4, 3]
    for i, s in enumerate(serial):
        want = TH.multi_step(model, s, 60.0, 3)
        got = ensemble.member(out, i)
        for f in dataclasses.fields(TH.State):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), (i, f.name)
        assert torch.equal(ensemble.compute_cfl_dt(model, out)[i],
                           TH.compute_cfl_dt(model, want))


def test_member_round_trip():
    """``member`` gives back the states ``stack_members`` took, and refuses a serial
    state; ``stack_members`` refuses no states and an ensemble."""
    _, base = torch_build(32, 24, dtype=torch.float64, substeps=6, device="cpu")
    states = [_scaled(base, s) for s in SCALES]
    batch = ensemble.stack_members(states)
    for i, s in enumerate(states):
        for f in dataclasses.fields(TH.State):
            assert torch.equal(getattr(ensemble.member(batch, i), f.name),
                               getattr(s, f.name))
    with pytest.raises(ValueError):
        ensemble.member(base, 0)
    with pytest.raises(ValueError):
        ensemble.stack_members([])
    with pytest.raises(ValueError):
        ensemble.stack_members([batch])


def test_refusals():
    """A dt per member is refused (sharded ensembles are
    ``tests/test_torch_sharded_ensemble.py``'s)."""
    model, base = torch_build(32, 24, dtype=torch.float64, substeps=6, device="cpu")
    batch = ensemble.stack_members([base, base])
    with pytest.raises(ValueError, match="one dt"):
        ensemble.ensemble_step(model, batch, torch.tensor([60.0, 30.0],
                                                          dtype=torch.float64))


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_plain_barotropic_members_bitwise(wrap, B):
    """The plain subcycle of a (B, Ye, Xe) member stack is B single calls, bit for
    bit, with one shared static pack, dtau and weights."""
    w = averaging_weights(30)[1]
    n_sub, Ny, Nx = len(w), 19, 26
    sets = [baro_inputs(Ny, Nx, n_sub + 1, seed=b) for b in range(B)]
    static = sets[0][0]
    stacks = [torch.stack([s[k] for s in sets]) for k in range(1, 6)]
    tail = (torch.tensor(0.01, dtype=torch.float64), torch.as_tensor(w), Nx, n_sub + 1,
            wrap)
    got = barotropic.barotropic_substeps(static, *stacks, *tail)
    for b in range(B):
        one = barotropic.barotropic_substeps(static, *(s[b] for s in stacks), *tail)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


@pytest.mark.parametrize("B,n", [(1, 1), (3, 1), (2, 3)])
@pytest.mark.parametrize("kappa", [False, True])
@pytest.mark.parametrize("with_acc", [False, True])
def test_plain_tracer_members_bitwise(B, n, kappa, with_acc):
    """The plain tracer tendency of B members (each member's n planes over its own u
    and v) is the single calls', bit for bit."""
    Yb, Xb = 23, 34
    r = np.random.default_rng(B + 3 * n + 7 * kappa)
    shape = (B, Yb, Xb) if n == 1 else (B, n, Yb, Xb)
    c = torch.as_tensor(r.standard_normal(shape))
    u, v = torch.as_tensor(r.standard_normal((2, B, Yb, Xb)))
    static = torch.as_tensor(1.0 + r.random((8 if kappa else 5, Yb, Xb)))
    acc = torch.as_tensor(r.standard_normal(shape)) if with_acc else None
    got = tracer_adv.tracer_adv(c, u, v, static, acc=acc).reshape(B, n, Yb, Xb)
    c4 = c.reshape(B, n, Yb, Xb)
    a4 = None if acc is None else acc.reshape(B, n, Yb, Xb)
    for b in range(B):
        one = tracer_adv.tracer_adv(c4[b], u[b], v[b], static,
                                    acc=None if a4 is None else a4[b])
        assert torch.equal(got[b], one)
    with pytest.raises(ValueError, match="members"):
        tracer_adv.tracer_adv(c[:1] if B > 1 else torch.cat([c, c]), u, v, static)


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("substeps,B", [(10, 3), (30, 2)])
def test_barotropic_member_plan_replay(wrap, substeps, B):
    """The kernel's member addressing replayed on flat buffers (member b at b·P of
    each component of the inputs, the work sets and the averages): each member is
    bitwise its one-member replay, and within 1e-12 of the plain version on the
    valid region."""
    w = averaging_weights(substeps)[1]
    n_sub, Ny, Nx = len(w), 23, 37
    H = n_sub + 1
    sets = [baro_inputs(Ny, Nx, H, seed=substeps + b) for b in range(B)]
    static = sets[0][0]
    stacks = [torch.stack([s[k] for s in sets]) for k in range(1, 6)]
    tail = (torch.tensor(0.01, dtype=torch.float64), torch.as_tensor(w), Nx, H, wrap)
    plan = barotropic._plan(Ny + 2 * H, Nx + 2 * H, n_sub, (64, 8, 6), 11, 8)
    assert len(plan.launches) == (1 if n_sub <= 11 else 2)
    got = baro_replay(static, *stacks, *tail, plan)
    assert got.shape == (3, B, Ny + 2 * H, Nx + 2 * H)
    want = barotropic.barotropic_substeps_plain(static, *stacks, *tail)
    I = (slice(None), slice(n_sub, -n_sub), slice(None) if wrap else slice(n_sub, -n_sub))
    for b in range(B):
        one = baro_replay(static, *(s[b] for s in stacks), *tail, plan)
        assert torch.equal(got[:, b], one)
    for g, ww in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - ww)[I].abs().max() / ww[I].abs().max()) <= 1e-12
