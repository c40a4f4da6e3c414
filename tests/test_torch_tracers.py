"""Several tracers in the PyTorch port's single-layer model at float64.

``tests/test_tracers.py`` ported (``State.c`` the (n, Ye, Xe) stack in
``tracer_names`` order; every plane evolves exactly as it would alone), and:

- each plane of a two-tracer run bitwise equal to its single-tracer run, and the flow
  bitwise equal (the port's plain path computes each plane with the same operations;
  the JAX package holds this only to rtol 1e-12 because XLA fuses stacks
  differently), with the WENO-5 kernel's plain version and with a plain scheme;
- the plain P-plane column ``tracer_adv`` against ``tracer_adv_pallas(...,
  interpret=True)`` for P = 2 and 3, with and without κ_h, rtol 1e-12 of the field's
  maximum on the cells both keep (the JAX kernel's reach is 4);
- three two-tracer steps with a per-tracer forcing, built from the JAX model's own
  arrays, against the jitted JAX steps, rtol 1e-12 (``tests/test_tracers.py:73``'s
  band); the per-tracer content against the JAX ``tracer_content`` within 1e-13 of
  each tracer's content norm (the two sums add in another order);
- the initializer forms and refusals, per-tracer content conservation;
- the two-tracer sharded run (split, the default) bitwise equal to serial through
  ``LocalExchange`` on 4 y-shards and on 2 x 2 blocks (the JAX package's sharded
  tracers are 1 ulp from serial; the port's split is bitwise);
- the stack through the output writer and ``FieldTimeSeries`` (read by both
  packages), npz checkpoints across the two packages, the NaN checker and the
  progress callback.
"""

import dataclasses
import os
import sys
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

from test_torch_model import jax_model_numpy, jax_state_numpy  # noqa: E402

import orthogonalsphericalshellgrids_tpu as osg  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import diagnostics as JD  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models.split_explicit import (  # noqa: E402
    SplitExplicitFreeSurface as JaxFS)
from orthogonalsphericalshellgrids_tpu.ops.pallas_adv import (  # noqa: E402
    pack_adv_statics, tracer_adv_pallas)
from orthogonalsphericalshellgrids_tpu.utils import checkpoint as JC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.utils import output as JO  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import (  # noqa: E402
    CC, CF, FC, TripolarGrid, kernels)
from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.models.diagnostics import (  # noqa: E402
    tracer_content)
from orthogonalsphericalshellgrids_tpu_torch.parallel import (  # noqa: E402
    distribute, distribute2d, gather_state, gather_state2d, make_mesh, make_mesh2d,
    sharded_step_fn, sharded_step_fn2d)
from orthogonalsphericalshellgrids_tpu_torch.utils import (  # noqa: E402
    FieldTimeSeries, IterationInterval, NaNChecker, OutputWriter, Simulation,
    load_checkpoint, progress_callback, save_checkpoint)

torch.set_num_threads(1)

STATE = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")


def bottom(lam, phi):
    land = (((np.abs(lam - 45.0) < 12) & (np.abs(35.0 - phi) < 12))
            | ((np.abs(lam - 225.0) < 12) & (np.abs(35.0 - phi) < 12))
            | (phi < -78))
    return np.where(land, 1.0, 0.0)


def _setup(tracers=("c",), ny=32, substeps=6, **kw):
    """``tests/test_tracers.py:_setup`` in the port: 32 x ``ny``, float64."""
    grid = TripolarGrid.make((32, ny, 1), dtype=torch.float64, first_pole_longitude=45.0,
                             north_poles_latitude=35.0, device="cpu")
    return TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
                         bottom_height=bottom, tracers=tracers, device="cpu", **kw)


def _jax_setup(tracers=("c",), ny=32, substeps=6, **kw):
    grid = osg.TripolarGrid.make((32, ny, 1), dtype=jnp.float64, first_pole_longitude=45.0,
                                 north_poles_latitude=35.0)
    return JH.make_model(grid, free_surface=JaxFS(substeps=substeps), bottom_height=bottom,
                         tracers=tracers, **kw)


def ui(lam, phi):
    return 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2


def vi(lam, phi):
    return 0.05 * np.sin(np.deg2rad(lam) * 3) * np.cos(np.deg2rad(phi) * 2)


def c1(lam, phi):
    return np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0)


def c2(lam, phi):
    return np.cos(np.deg2rad(lam) * 2) * np.exp(-((np.deg2rad(phi) * 3) ** 2))


def _run(model, state, n_steps=4, dt=120.0):
    return TH.multi_step(model, state, dt, n_steps)


def _relax_s(lam, phi, t, f):
    """A per-tracer forcing on S, on the arrays of either package."""
    return -1e-5 * (f.c[1] - 0.5) + 1e-9 * phi


@pytest.mark.parametrize("scheme", ["weno5", "centered4"])
def test_multi_tracer_matches_single(scheme):
    """Each plane of a two-tracer run is its single-tracer run, bitwise, and so is
    the flow; the stack's WENO-5 tendency is one tracer_adv call."""
    m2 = _setup(tracers=("T", "S"), tracer_advection=scheme)
    s2 = _run(m2, TH.initial_state(m2, u=ui, v=vi, c={"T": c1, "S": c2}))
    assert s2.c.shape == (2,) + m2.grid.shape2d and s2.Gc.shape == s2.c.shape
    for k, ci in enumerate([c1, c2]):
        m1 = _setup(tracer_advection=scheme)
        s1 = _run(m1, TH.initial_state(m1, u=ui, v=vi, c=ci))
        assert torch.equal(s2.c[k], s1.c), f"tracer plane {k}"
        assert torch.equal(s2.Gc[k], s1.Gc), f"tendency plane {k}"
        for name in ("u", "v", "eta", "U", "V"):
            assert torch.equal(getattr(s2, name), getattr(s1, name)), name


def test_initializer_forms_and_validation():
    m = _setup(tracers=("T", "S"))
    s = TH.initial_state(m, u=ui, c=[c1, None])  # a sequence, one None starts at 0
    assert s.c.shape[0] == 2 and bool((s.c[1] == 0.0).all())
    s = TH.initial_state(m, u=ui, c={"S": c2})  # a missing name starts at 0
    assert bool((s.c[0] == 0.0).all()) and bool((s.c[1] != 0.0).any())
    assert torch.equal(TH.initial_state(m, c=None).c, torch.zeros_like(s.c))
    with pytest.raises(ValueError, match="unknown tracer"):
        TH.initial_state(m, c={"X": c1})
    with pytest.raises(ValueError, match="initializers"):
        TH.initial_state(m, c=[c1])
    with pytest.raises(ValueError, match="unique"):
        _setup(tracers=("T", "T"))
    with pytest.raises(ValueError, match="non-empty"):
        _setup(tracers=())
    # one tracer takes a function, or a one-element sequence or dict: a plane
    m1 = _setup()
    for c in (c1, [c1], {"c": c1}):
        assert TH.initial_state(m1, c=c).c.shape == m1.grid.shape2d


@pytest.mark.parametrize("form", ["dict", "sequence"])
def test_initial_state_matches_jax(form):
    jm = _jax_setup(tracers=("T", "S"))
    tm = _setup(tracers=("T", "S"))
    c = {"T": c1, "S": c2} if form == "dict" else [c1, c2]
    js = JH.initial_state(jm, u=ui, v=vi, c=c)
    ts = TH.initial_state(tm, u=ui, v=vi, c=c)
    for name, want in jax_state_numpy(js).items():
        if name in ("U", "V"):  # h·u: the jitted JAX assembly may contract it
            np.testing.assert_allclose(getattr(ts, name).numpy(), want, rtol=1e-15,
                                       atol=1e-18, err_msg=name)
        else:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), want, err_msg=name)


def test_per_tracer_content_conserved():
    """tracer_content returns the per-tracer vector; flux-form advection conserves
    each plane's content across the fold, to round-off against the content norm."""
    m = _setup(tracers=("T", "S"))
    s0 = TH.initial_state(m, u=ui, v=vi, c=[c1, c2])
    q0 = tracer_content(m, s0).numpy()
    assert q0.shape == (2,)
    q1 = tracer_content(m, _run(m, s0, n_steps=6)).numpy()
    g = m.grid
    vol = g.interior(g.az_cc * m.ib.h_c).numpy()
    norm = np.abs(g.interior(s0.c).numpy()).reshape(2, -1) @ vol.ravel()
    assert np.all(np.abs(q1 - q0) <= 1e-12 * norm), (q0, q1, norm)


def _assert_content_close(model, state, got, want, rtol):
    """Per-tracer contents within ``rtol`` of each tracer's content norm Σ|c|·Az·H
    (the signed content of an oscillatory tracer is a small residual of cancelling
    terms, so its round-off scales with the norm; ``tests/test_tracers.py:105``)."""
    g = model.grid
    vol = g.interior(g.az_cc * model.ib.h_c).numpy().ravel()
    norm = np.abs(g.interior(state.c).numpy()).reshape(len(got), -1) @ vol
    assert np.all(np.abs(got - want) <= rtol * norm), (got, want, norm)


@pytest.fixture(scope="module")
def pair():
    """A two-tracer JAX model with a forcing on S, and the port's model and state
    built from its leaves."""
    jm = _jax_setup(tracers=("T", "S"), forcing={"S": _relax_s})
    js = JH.initial_state(jm, u=ui, v=vi, c=[c1, c2])
    arrays, meta = jax_model_numpy(jm)
    tm = TH.from_jax_arrays(arrays, meta, device="cpu")
    return jm, js, tm, TH.state_from_numpy(jax_state_numpy(js), device="cpu")


def test_from_jax_arrays_carries_the_tracers(pair):
    jm, js, tm, ts = pair
    assert tm.tracer_names == jm.tracer_names == ("T", "S")
    assert (tm.tracer_advection, tm.momentum_advection) == ("weno5", "weno_vector_invariant")
    assert ts.c.shape == (2,) + tm.grid.shape2d
    _assert_content_close(tm, ts, tracer_content(tm, ts).numpy(),
                          np.asarray(JD.tracer_content(jm, js)), 1e-13)


def test_multi_tracer_steps_match_jax(pair):
    jm, js, tm, ts = pair
    jout = jax.jit(partial(JH.multi_step, n_steps=3))(jm, js, 120.0)
    tout = TH.multi_step(tm, ts, 120.0, 3)
    g, ge = jm.grid, jm.grid_ext
    for name in STATE:
        grid = ge if name in ("eta", "U", "V") else g
        want = np.asarray(grid.interior(getattr(jout, name)))
        got = grid.interior(getattr(tout, name)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)
    _assert_content_close(tm, tout, tracer_content(tm, tout).numpy(),
                          np.asarray(JD.tracer_content(jm, jout)), 1e-12)


def test_per_tracer_forcing_lands_in_its_plane(pair):
    """The forcing on S changes S's tendency only (T's equals the unforced model's)."""
    jm, js, tm, ts = pair
    g = tm.grid
    unforced = TH.from_jax_arrays(*jax_model_numpy(dataclasses.replace(jm, forcing=())),
                                  device="cpu")
    fields = [TH._fill(g, a, loc, s) for a, loc, s in ((ts.u, FC, -1), (ts.v, CF, -1),
                                                        (ts.c, CC, 1))]
    _, _, Gc = TH.tendencies(tm, *fields)
    _, _, G0 = TH.tendencies(unforced, *fields)
    assert torch.equal(Gc[0], G0[0])
    I = g.interior2d
    assert not torch.equal(Gc[1][I], G0[1][I])


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("kappa", [False, True])
def test_plain_planes_match_pallas(P, kappa):
    """The plain column tracer_adv over a (P, Yb, Xb) stack against the JAX Pallas
    kernel's column mode over the same stack (``n_tr = P``, nz = 1), interpret mode."""
    r = np.random.default_rng(P + 10 * kappa)
    Yb, Xb = 60, 76
    c = r.standard_normal((P, Yb, Xb))
    u, v = r.standard_normal((2, Yb, Xb))
    st = 1.0 + r.random((8 if kappa else 5, Yb, Xb))
    h_u, dy_fc, h_v, dx_cf, iv = (jnp.asarray(x) for x in st[:5])
    kap = [jnp.asarray(x)[None] for x in st[5:]]
    pack = pack_adv_statics((h_u * dy_fc)[None], (h_v * dx_cf)[None], iv[None], *kap)
    want = np.asarray(tracer_adv_pallas(jnp.asarray(c), jnp.asarray(u)[None],
                                        jnp.asarray(v)[None], statics_packed=pack,
                                        interpret=True, block_rows=32))
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(*(torch.as_tensor(x) for x in (c, u, v, st))).numpy()
    assert kernels.launch_counts()["tracer_adv_planes"] == 0  # the CPU: the plain version
    I = (Ellipsis, slice(4, -4), slice(4, -4))
    assert np.abs(got[I] - want[I]).max() <= 1e-12 * np.abs(want[I]).max()


@pytest.mark.parametrize("mesh", [4, (2, 2)])
def test_multi_tracer_sharded_bitwise(mesh):
    """The two-tracer step on 4 y-shards or 2 x 2 blocks (the split, by default)
    bitwise equal to serial, every field."""
    model = _setup(tracers=("T", "S"))
    state = TH.initial_state(model, u=ui, v=vi, c=[c1, c2])
    if isinstance(mesh, int):
        m = make_mesh(mesh)
        dm, ds = distribute(model, state, m)
        fn = sharded_step_fn(m, dm)
        gather = partial(gather_state, model_serial=model, n=mesh)
    else:
        m = make_mesh2d(*mesh)
        dm, ds = distribute2d(model, state, m)
        fn = sharded_step_fn2d(m, dm, model.grid.Nx)
        gather = partial(gather_state2d, model_serial=model, mesh=m)
    assert all(x.tracer_names == ("T", "S") for x in dm)
    for _ in range(4):
        ds = fn(ds, 120.0)
    fn.close()
    got, want = gather(ds), _run(model, state)
    for name in STATE:
        grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
        assert torch.equal(grid.interior(getattr(got, name)),
                           grid.interior(getattr(want, name))), name


def test_stack_through_writer_and_checkpoints(tmp_path):
    """The (2, Ye, Xe) stack through the output writer (read back by both packages'
    FieldTimeSeries) and npz checkpoints written by one package and read by the
    other."""
    m = _setup(tracers=("T", "S"))
    s = TH.initial_state(m, u=ui, v=vi, c=[c1, c2])
    sim = Simulation(m, s, dt=120.0, stop_iteration=4)
    path = str(tmp_path / "out.npz")
    sim.add_callback(OutputWriter(path, {"c": lambda x: x.state.c}), IterationInterval(2))
    out = sim.run()
    g = m.grid
    for fts in (FieldTimeSeries(path, "c"), JO.FieldTimeSeries(path, "c")):
        assert len(fts) == 2 and fts[1].shape == (2, g.Ny, g.Nx)
        np.testing.assert_array_equal(fts[1], g.interior(out.c).numpy())
    # port -> JAX -> port
    jm = _jax_setup(tracers=("T", "S"))
    like = JH.initial_state(jm, c=[c1, c2])
    save_checkpoint(str(tmp_path / "a.npz"), out)
    back = JC.load_checkpoint(str(tmp_path / "a.npz"), like)
    np.testing.assert_array_equal(np.asarray(back.c), out.c.numpy())
    JC.save_checkpoint(str(tmp_path / "b.npz"), back)
    again = load_checkpoint(str(tmp_path / "b.npz"), out)
    for f in dataclasses.fields(out):
        assert torch.equal(getattr(again, f.name), getattr(out, f.name)), f.name


@pytest.mark.parametrize("plane", [0, 1])
def test_nan_checker_and_progress_read_the_stack(plane):
    """A NaN in either plane of the stack aborts a run that checks c; the progress
    line runs on a two-tracer state."""
    m = _setup(tracers=("T", "S"))
    s = TH.initial_state(m, u=ui, v=vi, c=[c1, c2])
    lines = []
    sim = Simulation(m, s, dt=120.0, stop_iteration=2)
    sim.add_callback(progress_callback(lines.append), IterationInterval(1))
    sim.run()
    assert len(lines) == 2
    bad = s.c.clone()
    bad[plane, m.grid.Hy + 3, m.grid.Hx + 4] = float("nan")
    sim = Simulation(m, dataclasses.replace(s, c=bad), dt=120.0, stop_iteration=3,
                     nan_checker=False)
    sim.add_callback(NaNChecker(("u", "c")), IterationInterval(1))
    with pytest.raises(RuntimeError, match="non-finite values in 'c'"):
        sim.run()
