"""The port's simulation layer against the JAX package, on the CPU.

Mirrors ``tests/test_utils.py`` case for case on ``orthogonalsphericalshellgrids_tpu_torch
.utils`` and ``models/diagnostics.py`` (rotation, checkpoints, diagnostics, the
writers, profiling, the NaN checker, pickup, ``Checkpointer.latest``, schedule
realignment) and adds what only a port has to show:

- npz checkpoints and OutputWriter archives cross between the packages both ways;
- the diagnostics equal the JAX ones at float64 (rtol 1e-12);
- the port's ``Simulation`` reproduces the JAX ``Simulation`` at float64 for the
  single-layer and the layered model: the same Δt sequence from the wizard and the
  final state within rtol 1e-12 (XLA:CPU contracts multiply-adds where eager PyTorch
  does not);
- the examples' ``main()`` run at small sizes with ``--device cpu``, and every entry
  point defaults to the card.
"""

import dataclasses
import inspect
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import examples.baroclinic_front_torch as front_ex  # noqa: E402
import examples.bickley_jet_torch as bickley_ex  # noqa: E402
import examples.convert_to_latlong_frame_torch as convert_ex  # noqa: E402
import examples.wind_driven_ts_gyre_torch as gyre_ex  # noqa: E402
import orthogonalsphericalshellgrids_tpu as osg  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import diagnostics as JD  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu.utils import checkpoint as JC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.utils import output as JO  # noqa: E402
from orthogonalsphericalshellgrids_tpu.utils import rotation as JR  # noqa: E402
from orthogonalsphericalshellgrids_tpu.utils import simulation as JS  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid, kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import diagnostics as TD  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.utils import (  # noqa: E402
    Checkpointer, FieldTimeSeries, IterationInterval, NaNChecker, NetCDFWriter,
    OutputWriter, Simulation, TimeInterval, TimeStepWizard, load_checkpoint,
    progress_callback, read_netcdf_series, save_checkpoint)
from orthogonalsphericalshellgrids_tpu_torch.utils import profiling, rotation  # noqa: E402

torch.set_num_threads(1)


INIT = dict(u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
            v=lambda lam, phi: 0.1 * np.cos(np.deg2rad(lam)),
            c=lambda lam, phi: np.sin(np.deg2rad(phi)))


def make(ny=24, nx=32):
    """``tests/test_utils.py:make`` in the port: a 32 x 24 float64 grid, substeps 8."""
    grid = TripolarGrid.make((nx, ny, 1), dtype=torch.float64, device="cpu")
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=8),
                          device="cpu")
    return model, TH.initial_state(model, **INIT)


def jax_make(ny=24, nx=32):
    grid = osg.TripolarGrid.make((nx, ny, 1), dtype=jnp.float64)
    model = JH.make_model(grid, free_surface=JH.SplitExplicitFreeSurface(substeps=8))
    return model, JH.initial_state(model, **INIT)


def _interior(grid, a):
    return np.asarray(a)[..., grid.Hy:grid.Hy + grid.Ny, grid.Hx:grid.Hx + grid.Nx]


# --- rotation ----------------------------------------------------------------------

def test_rotation_round_trip():
    """native -> latlon -> native is the identity wherever the rotation is defined,
    and the rotation is near the identity at the equator."""
    model, _ = make()
    g = model.grid
    u = torch.ones(g.shape2d, dtype=torch.float64)
    v = 0.3 * torch.ones(g.shape2d, dtype=torch.float64)
    ub, vb = rotation.to_native_frame(g, *rotation.to_latlon_frame(g, u, v))
    d1, d2 = rotation.rotation_angle(g)
    defined = g.interior(d1**2 + d2**2).numpy() > 0.99
    np.testing.assert_allclose(g.interior(ub).numpy()[defined], 1.0, atol=1e-10)
    np.testing.assert_allclose(g.interior(vb).numpy()[defined], 0.3, atol=1e-10)
    near_eq = np.abs(g.interior(g.phi_cc).numpy()) < 10
    np.testing.assert_allclose(g.interior(d1).numpy()[near_eq], 1.0, atol=0.05)


def test_rotation_matches_jax():
    """rotation_angle and both maps equal the JAX package's at float64."""
    model, _ = make()
    jm, _ = jax_make()
    rng = np.random.default_rng(0)
    u, v = rng.standard_normal((2,) + model.grid.shape2d)
    for fn in ("rotation_angle", "to_latlon_frame", "to_native_frame"):
        args = () if fn == "rotation_angle" else (u, v)
        got = getattr(rotation, fn)(model.grid, *(torch.from_numpy(a) for a in args))
        want = getattr(JR, fn)(jm.grid, *(jnp.asarray(a) for a in args))
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-12,
                                       atol=1e-14, err_msg=fn)


# --- checkpoints -------------------------------------------------------------------

def test_checkpoint_npz_round_trip(tmp_path):
    _, state = make()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)
    assert not os.path.exists(path + ".tmp")
    s2 = load_checkpoint(path, state)
    assert type(s2) is type(state)
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(s2, f.name), getattr(state, f.name)), f.name


def _random_fields(kind, rng):
    cls = TH.State if kind == "single" else TL.LayeredState
    out = {}
    for f in dataclasses.fields(cls):
        if f.name == "iteration":
            out[f.name] = np.asarray(7, np.int32)
        elif f.name == "t":
            out[f.name] = np.asarray(rng.random())
        else:
            out[f.name] = rng.standard_normal((3, 6, 8) if kind == "layered" else (6, 8))
    return out


@pytest.mark.parametrize("kind", ["single", "layered"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, kind, writer):
    """A checkpoint written by either package loads into the other, leaf for leaf
    (both write the dataclass fields in order as leaf_0 ... leaf_n)."""
    fields = _random_fields(kind, np.random.default_rng(len(kind)))
    jcls = JH.State if kind == "single" else JL.LayeredState
    tcls = TH.State if kind == "single" else TL.LayeredState
    jstate = jcls(**{k: jnp.asarray(v) for k, v in fields.items()})
    tstate = tcls(**{k: torch.from_numpy(v.copy()) for k, v in fields.items()})
    path = str(tmp_path / "cross.npz")
    if writer == "jax":
        JC.save_checkpoint(path, jstate)
        got = load_checkpoint(path, tstate)
        pairs = [(getattr(got, k).numpy(), v) for k, v in fields.items()]
    else:
        save_checkpoint(path, tstate)
        got = JC.load_checkpoint(path, jstate)
        pairs = [(np.asarray(getattr(got, k)), v) for k, v in fields.items()]
    for a, b in pairs:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_checkpoint_needs_npz(tmp_path):
    _, state = make()
    for fn in (lambda p: save_checkpoint(p, state), lambda p: load_checkpoint(p, state)):
        with pytest.raises(ValueError, match="npz"):
            fn(str(tmp_path / "orbax_dir"))


# --- diagnostics -------------------------------------------------------------------

@pytest.fixture(scope="module")
def diag_pair():
    """The JAX make() after two steps (nonzero tendencies, filled free surface) and
    the same state in the port, with a layered check gyre for the layered functional.
    Both packages get the same state: Σ η·Az cancels to 1e-9 of its terms, so a
    round-off difference between two stepped states would dominate it."""
    model, _ = make()
    jm, js = jax_make()
    js = jax.jit(lambda m, s: JH.multi_step(m, s, 60.0, 2))(jm, js)
    state = TH.state_from_numpy({f.name: np.asarray(getattr(js, f.name))
                                 for f in dataclasses.fields(js)}, "cpu")
    lm, ls = gyre_ex.build_check(device="cpu")
    jl = JL.make_layered_model(
        osg.TripolarGrid.make((48, 32, 3), dtype=jnp.float64, z=(-1000.0, 0.0),
                              first_pole_longitude=gyre_ex.CHECK_LAM_P,
                              north_poles_latitude=gyre_ex.CHECK_PHI_P),
        free_surface=JH.SplitExplicitFreeSurface(substeps=6),
        bottom_height=gyre_ex.check_bottom, use_pallas=False, **gyre_ex.CHECK_OPTIONS)
    jls = JL.layered_initial_state(jl, **gyre_ex.CHECK_INIT)
    return dict(model=model, state=state, jm=jm, js=js, lm=lm, ls=ls, jl=jl, jls=jls)


DIAGNOSTICS = ["vertical_vorticity", "kinetic_energy", "seam_row_weights",
               "tracer_content", "surface_volume", "layered_tracer_content",
               "max_speeds", "advective_cfl"]


@pytest.mark.parametrize("name", DIAGNOSTICS)
def test_diagnostics_match_jax(diag_pair, name):
    p = diag_pair
    if name == "seam_row_weights":
        got = (TD.seam_row_weights(24, torch.float64),)
        want = (JD.seam_row_weights(24, jnp.float64),)
    elif name == "layered_tracer_content":
        got = [TD.layered_tracer_content(p["lm"], p["ls"]),
               TD.layered_tracer_content(p["lm"], p["ls"], field="u")]
        want = [JD.layered_tracer_content(p["jl"], p["jls"]),
                JD.layered_tracer_content(p["jl"], p["jls"], field="u")]
    elif name == "advective_cfl":
        got = (TD.advective_cfl(p["model"], p["state"], 60.0),)
        want = (JD.advective_cfl(p["jm"], p["js"], 60.0),)
    else:
        got = getattr(TD, name)(p["model"], p["state"])
        want = getattr(JD, name)(p["jm"], p["js"])
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
    assert len(got) == len(want)
    scale = 0.0
    if name == "surface_volume":
        # Σ η·Az cancels to about 1e-6 of Σ |η·Az|, so the two summation orders
        # differ by round-off of the terms, not of the result
        ge = p["jm"].grid_ext
        scale = float(np.abs(np.asarray(ge.interior(p["js"].eta * ge.az_cc))).sum())
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(w_).max(), scale, 1e-300),
                                   err_msg=name)
    if name == "kinetic_energy":
        assert float(got[0].min()) >= 0
    if name == "max_speeds":
        assert 0.9 < float(got[0]) <= 1.2


# --- writers -----------------------------------------------------------------------

def test_output_writer_round_trip(tmp_path):
    """Sync writer: interior crops of base and widened fields, times, and the archive
    reads back the same through the JAX package's FieldTimeSeries."""
    model, state = make()
    path = str(tmp_path / "run.npz")
    writer = OutputWriter(path, {"c": lambda sim: sim.state.c,
                                 "eta": lambda sim: sim.state.eta})
    sim = Simulation(model, state, dt=60.0, stop_iteration=4)
    sim.add_callback(writer, IterationInterval(2))
    sim.run()
    fts = FieldTimeSeries(path, "c")
    assert len(fts) == 2
    assert fts[0].shape == (model.grid.Ny, model.grid.Nx)
    assert np.all(np.isfinite(fts.data))
    np.testing.assert_allclose(fts.times, [120.0, 240.0])
    np.testing.assert_array_equal(fts[1], model.grid.interior(sim.state.c).numpy())
    eta = FieldTimeSeries(path, "eta")
    assert eta[0].shape == (model.grid_ext.Ny, model.grid_ext.Nx)
    jfts = JO.FieldTimeSeries(path, "c")
    np.testing.assert_array_equal(jfts.data, fts.data)
    np.testing.assert_array_equal(jfts.times, fts.times)


def test_output_writer_async(tmp_path):
    """Async writer: every snapshot reaches disk by the end of run(), each a copy
    taken when the callback fired (a layered stack keeps its leading Nz)."""
    model, state = gyre_ex.build_check(device="cpu")
    path = str(tmp_path / "run_async.npz")
    seen = []

    def u_out(sim):
        seen.append(sim.state.u.clone())
        return sim.state.u

    writer = OutputWriter(path, {"u": u_out}, async_write=True)
    sim = Simulation(model, state, dt=60.0, stop_iteration=4)
    sim.add_callback(writer, IterationInterval(1))
    sim.run()
    fts = FieldTimeSeries(path, "u")
    assert len(fts) == 4 and np.all(np.isfinite(fts.data))
    assert fts[0].shape == (3, model.grid.Ny, model.grid.Nx)
    for k in range(4):
        np.testing.assert_array_equal(fts[k], model.grid.interior(seen[k]).numpy())


def test_netcdf_writer_round_trip(tmp_path):
    model, state = make()
    path = str(tmp_path / "out.nc")
    w = NetCDFWriter(path, {"c": lambda s: s.state.c, "eta": lambda s: s.state.eta})
    sim = Simulation(model, state, dt=30.0, stop_iteration=4)
    sim.add_callback(w, IterationInterval(2))
    sim.run()
    times, c = read_netcdf_series(path, "c")
    assert len(times) == 2 and np.all(np.diff(times) > 0)
    g = model.grid
    assert c.shape == (2, g.Ny, g.Nx)
    np.testing.assert_allclose(c[-1], g.interior(sim.state.c).numpy())
    _, eta = read_netcdf_series(path, "eta")
    assert eta.shape[1:] == (model.grid_ext.Ny, model.grid_ext.Nx)
    _, lam = read_netcdf_series(path, "lam_cc")
    assert np.asarray(lam).shape[-2:] == (g.Ny, g.Nx)
    jtimes, jc = JO.read_netcdf_series(path, "c")
    np.testing.assert_array_equal(jc, c)


# --- profiling ---------------------------------------------------------------------

def test_profiling_helpers(tmp_path):
    """On the CPU: step timing, a profiler trace, device_sync as a no-op, and the two
    ceilings over their plain versions (host-clock numbers about the CPU)."""
    model, state = make()
    ms, s = profiling.time_steps(TH.step, model, state, 60.0, n=3, warmup=1)
    assert ms > 0 and bool(torch.isfinite(s.u).all())
    assert profiling.device_sync(s) is s
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        TH.step(model, state, 60.0)
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    kernels.reset_launch_counts()
    assert profiling.stream_probe_gbps(n=4096, n_launches=2, reps=1, device="cpu") > 0
    assert profiling.fma_ceiling(n=64, n_iter=2, reps=1, device="cpu") > 0
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_time_ms_takes_the_median_window():
    """``time_ms`` runs ``warm`` calls, then ``reps`` windows of ``n`` calls, and
    returns the median window per call: windows of about 20, 0 and 40 ms give at
    least 20 ms (the best would give about 0)."""
    import time

    sleeps = [0.0, 0.02, 0.0, 0.04]  # the warm-up call, then one call a window
    calls = []

    def fn():
        time.sleep(sleeps[len(calls)])
        calls.append(1)

    ms = profiling.time_ms(fn, n=1, reps=3, warm=1, device="cpu")
    assert len(calls) == 4 and 20.0 <= ms


# --- the simulation loop -----------------------------------------------------------

@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_nan_checker_aborts(bad):
    """A NaN or an infinity in any checked field aborts the run (the checker reads
    each field's min and max, which carry both)."""
    model, state = make()
    sim = Simulation(model, state, dt=30.0, stop_iteration=3)
    assert any(isinstance(fn, NaNChecker) for _, fn in sim.callbacks)  # default
    c = state.c.clone()
    c[10, 10] = bad
    sim = Simulation(model, dataclasses.replace(state, c=c), dt=30.0, stop_iteration=3)
    sim.add_callback(NaNChecker(("u", "c")), IterationInterval(1))
    with pytest.raises(RuntimeError, match="non-finite values in 'c'"):
        sim.run()


def test_progress_line_reads_the_max_speeds():
    model, state = make()
    lines = []
    sim = Simulation(model, state, dt=30.0, stop_iteration=2)
    sim.add_callback(progress_callback(lines.append), IterationInterval(2))
    s = sim.run()
    want = (f"velocity: {float(s.u.abs().max()):.2e} {float(s.v.abs().max()):.2e}")
    assert len(lines) == 1 and lines[0].endswith(want) and "iter      2" in lines[0]


def test_checkpointer_pickup(tmp_path):
    """Periodic Checkpointer + run(pickup=True): resuming from the newest checkpoint
    reproduces the straight-through trajectory bitwise."""
    prefix = str(tmp_path / "ck")
    model, state = make()
    simA = Simulation(model, state, dt=30.0, stop_iteration=6)
    simA.add_callback(Checkpointer(prefix), IterationInterval(3))
    simA.run()
    assert Checkpointer.latest(prefix).endswith("_iteration6.npz")
    simB = Simulation(model, state, dt=30.0, stop_iteration=9)
    simB.add_callback(Checkpointer(prefix), IterationInterval(3))
    endB = simB.run(pickup=True)
    assert int(endB.iteration) == 9 and simB.iteration == 9
    endC = Simulation(model, state, dt=30.0, stop_iteration=9).run()
    for f in dataclasses.fields(endC):
        assert torch.equal(getattr(endB, f.name), getattr(endC, f.name)), f.name
    with pytest.raises(ValueError, match="pickup=True"):
        Simulation(model, state, dt=30.0, stop_iteration=1).run(pickup=True)


def test_checkpointer_latest_edge_cases(tmp_path):
    """latest() keys on the final _iteration<N> token and escapes glob
    metacharacters."""
    d = tmp_path / "run_iteration7[x]"
    d.mkdir()
    prefix = str(d / "ck")
    for it in (2, 10):
        open(f"{prefix}_iteration{it}.npz", "wb").write(b"x")
    assert Checkpointer.latest(prefix).endswith("_iteration10.npz")
    assert Checkpointer.latest(str(tmp_path / "none")) is None


def test_pickup_realigns_time_schedules(tmp_path):
    """A resumed run fires the TimeInterval events of the uninterrupted run."""
    model, state = make()
    prefix = str(tmp_path / "ck")

    def run_collect(sim, pickup=None):
        fired = []
        sim.add_callback(lambda s: fired.append(round(s.time)), TimeInterval(300.0))
        sim.run(pickup=pickup)
        return fired

    ref = run_collect(Simulation(model, state, dt=60.0, stop_iteration=12))
    simA = Simulation(model, state, dt=60.0, stop_iteration=6)
    simA.add_callback(Checkpointer(prefix), IterationInterval(6))
    firedA = run_collect(simA)
    simB = Simulation(model, state, dt=60.0, stop_iteration=12)
    simB.add_callback(Checkpointer(prefix), IterationInterval(6))
    firedB = run_collect(simB, pickup=True)
    assert firedA + firedB == ref, (firedA, firedB, ref)


def _jax_bickley():
    from examples.bickley_jet import build

    return build(48, 32, dtype=jnp.float64)


def _jax_gyre():
    from examples.wind_driven_ts_gyre import build

    return build(48, 32, 3, dtype=jnp.float64)


# (port build, JAX build, days, dt, wizard) of the examples' main() runs
RUNS = {
    "bickley": (lambda: bickley_ex.build(48, 32, dtype=torch.float64, device="cpu"),
                _jax_bickley, 0.05, 60.0, dict(cfl=0.3, max_change=1.1, max_dt=3 * 3600.0)),
    "gyre": (lambda: gyre_ex.build(48, 32, 3, dtype=torch.float64, device="cpu"),
             _jax_gyre, 0.1, 300.0, dict(cfl=0.25, max_change=1.1, max_dt=3600.0)),
}


def _drive(sim_cls, wizard, model, state, days, dt):
    """The examples' loop: the wizard every 10 iterations, and Δt recorded after
    every step."""
    sim = sim_cls(model, state, dt=dt, stop_time=days * 86400.0)
    sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                     IterationInterval(10))
    dts = []
    sim.add_callback(lambda s: dts.append(s.dt), IterationInterval(1))
    return sim.run(), dts, sim


@pytest.mark.parametrize("run", sorted(RUNS))
def test_simulation_matches_jax(run):
    """The port's Simulation against the JAX Simulation at float64, from the same
    example build: the same Δt sequence and the same final state (rtol 1e-12)."""
    build_t, build_j, days, dt, wiz = RUNS[run]
    tm, ts = build_t()
    jm, js = build_j()
    tout, tdts, tsim = _drive(Simulation, TimeStepWizard(**wiz), tm, ts, days, dt)
    jout, jdts, jsim = _drive(JS.Simulation, JS.TimeStepWizard(**wiz), jm, js, days, dt)
    assert len(tdts) == len(jdts) and len(tdts) > 10
    assert max(tdts) > dt  # the wizard grew Δt
    np.testing.assert_allclose(tdts, jdts, rtol=1e-12)
    assert tsim.iteration == jsim.iteration
    assert tsim.time == pytest.approx(jsim.time, rel=1e-14)
    g, ge = jm.grid, jm.grid_ext
    for f in dataclasses.fields(tout):
        want = np.asarray(getattr(jout, f.name))
        got = getattr(tout, f.name).numpy()
        if want.ndim < 2:
            np.testing.assert_allclose(got, want, rtol=1e-14, err_msg=f.name)
            continue
        grid = ge if f.name in ("eta", "U", "V") else g
        want, got = _interior(grid, want), _interior(grid, got)
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want).max(), 1e-300),
                                   err_msg=f.name)


# --- the examples ------------------------------------------------------------------

def test_example_main_bickley(tmp_path, capsys):
    out = str(tmp_path / "bickley.npz")
    bickley_ex.main(["--nx", "48", "--ny", "32", "--days", "0.05", "--device", "cpu",
                     "--out", out])
    assert "done: iter=" in capsys.readouterr().out
    zeta = FieldTimeSeries(out, "zeta")
    assert len(zeta) >= 1 and np.isfinite(zeta.data).all()


def test_example_main_front(tmp_path):
    """The layered front: finite output and a thermal-wind jet along the front."""
    out = str(tmp_path / "front.npz")
    front_ex.main(["--nx", "48", "--ny", "32", "--nz", "4", "--days", "0.05", "--dt",
                   "120", "--device", "cpu", "--out", out])
    us = FieldTimeSeries(out, "u_surface")
    last = us[len(us) - 1]
    assert np.isfinite(last).all() and np.abs(last).max() > 0.0


def test_example_main_gyre(tmp_path):
    """The gyre: finite, bounded tracers and flow spun up from rest by the wind."""
    out = str(tmp_path / "gyre.npz")
    gyre_ex.main(["--nx", "48", "--ny", "32", "--nz", "3", "--days", "0.1", "--dt", "300",
                  "--device", "cpu", "--out", out])
    T = FieldTimeSeries(out, "T_surface")[0]
    u = FieldTimeSeries(out, "u_surface")[0]
    assert np.isfinite(T).all() and np.isfinite(u).all()
    assert T.max() <= 20.0 + 1e-3 and T.min() >= 0.0
    assert np.abs(u).max() > 0.0


def test_example_main_convert_to_latlong_frame():
    err_u, err_v = convert_ex.main(["--device", "cpu"])
    assert err_u < 1e-10 and err_v < 1e-10


class _Device(Exception):
    pass


def _capture_device(*args, device, **kwargs):
    raise _Device(device)


def test_entry_points_default_to_the_card(monkeypatch):
    """The grid, both models and the examples' builds default to device="cuda", and
    every example's --device flag to cuda; the CPU runs only when asked for."""
    for fn in (TripolarGrid.make, TH.make_model, TL.make_layered_model, bickley_ex.build,
               front_ex.build, gyre_ex.build, gyre_ex.build_check):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for mod in (bickley_ex, front_ex, gyre_ex):
        monkeypatch.setattr(mod, "build", _capture_device)
        with pytest.raises(_Device) as e:
            mod.main([])
        assert e.value.args[0] == "cuda"
    monkeypatch.setattr(TripolarGrid, "make", _capture_device)
    with pytest.raises(_Device) as e:
        convert_ex.main([])
    assert e.value.args[0] == "cuda"
