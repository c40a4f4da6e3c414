"""Checkpoint directories in the PyTorch port (``utils/checkpoint.py`` through
``torch.distributed.checkpoint``, DCP), against the JAX package's orbax route, at
float64 on the CPU.

- ``save_checkpoint`` and ``load_checkpoint`` on a directory: ``State``,
  ``LayeredState`` (gyre and front options) and a 3-member batch of each round trip
  bitwise; a float32 ``like`` gets the saved float64 values cast, as orbax casts
  them; a field of another shape is refused, naming it;
- ``save_sharded_checkpoint`` and ``load_sharded_checkpoint`` on a directory: 2 and 4
  y-shards and 2 x 2 blocks through ``LocalExchange``, one member and 3, round trip
  bitwise and step on bitwise, each rank's tensors loaded from its own keys only; a
  load onto another decomposition is refused; 2 processes of a gloo group
  (``ProcessGroupExchange``) read a directory ``LocalExchange`` wrote and write one it
  reads back, bitwise, each process loading its own rank's keys only;
- ``Checkpointer(prefix, npz=False)`` with ``Simulation.run(pickup=...)``: resumed at
  iteration 3 and at the newest (``pickup=True``) bitwise the uninterrupted run;
  ``latest`` skips a directory still being written (``.tmp``) and one without
  ``.metadata``; a path that cannot be written raises through ``Simulation.run``;
- the 48 x 32 Bickley jet checkpointed at iteration 3 and resumed to 6 by each
  package (orbax and DCP directories): each bitwise its own uninterrupted run, and
  the two within rtol 1e-12 of each other (XLA:CPU contracts multiply-adds where
  eager PyTorch does not);
- ``parallel/layouts.py:classify_tree`` equal to the JAX package's tags.

The module imports no jax at its top, so that the processes of the gloo test import
it quickly; the tests that compare with the JAX package import it inside.
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import examples.bickley_jet_torch as bickley_ex  # noqa: E402
import examples.wind_driven_ts_gyre_torch as gyre_ex  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface, ensemble)
from orthogonalsphericalshellgrids_tpu_torch.parallel import (  # noqa: E402
    ProcessGroupExchange, ShardedStep, distribute, distribute2d, distribute_layered,
    distribute_layered2d, make_mesh, make_mesh2d, sharded_layered_step_fn,
    sharded_layered_step_fn2d, sharded_step_fn, sharded_step_fn2d, spawn)
from orthogonalsphericalshellgrids_tpu_torch.parallel.layouts import (  # noqa: E402
    classify_tree)
from orthogonalsphericalshellgrids_tpu_torch.utils import (  # noqa: E402
    Checkpointer, IterationInterval, Simulation, load_checkpoint,
    load_sharded_checkpoint, save_checkpoint, save_sharded_checkpoint)

torch.set_num_threads(1)

LAM_P, PHI_P = 45.0, 25.0  # tests/test_distributed.py's poles


def _land(lam, phi):
    return (((np.abs(lam - LAM_P) < 10) & (np.abs(PHI_P - phi) < 10))
            | ((np.abs(lam - (LAM_P + 180.0)) < 10) & (np.abs(PHI_P - phi) < 10))
            | (phi < -78))


U0 = dict(u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
          v=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 3),
          c=lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0))
FRONT_B = dict(b=lambda lam, phi, z: 1e-5 * z - 1e-3 * np.tanh((phi - 30.0) / 5.0)
               * np.exp(z / 500.0))
LAYERED = {"gyre": (gyre_ex.CHECK_OPTIONS, gyre_ex.CHECK_INIT),
           # the baroclinic front's options (examples/baroclinic_front_torch.py:build)
           "front": (dict(buoyancy=True, coriolis=True, nu_v=1e-4, kappa_v=1e-5), FRONT_B)}


def build(kind):
    """(model, state, step) of ``kind`` on a 32 x 48 float64 grid (4 y-shards and 2 x 2
    blocks divide it): the single-layer jet of ``tests/test_distributed.py:
    small_model``, or the layered model with 3 layers and the gyre's or the front's
    options."""
    nz = 1 if kind == "single" else 3
    grid = TripolarGrid.make((32, 48, nz), dtype=torch.float64, z=(-1000.0, 0.0),
                             first_pole_longitude=LAM_P, north_poles_latitude=PHI_P,
                             device="cpu")
    if kind == "single":
        model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=6),
                              bottom_height=lambda lam, phi: np.where(_land(lam, phi),
                                                                      1.0, 0.0),
                              device="cpu")
        return model, TH.initial_state(model, **U0), TH.step
    options, init = LAYERED[kind]
    model = TL.make_layered_model(
        grid, free_surface=SplitExplicitFreeSurface(substeps=6),
        bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, -1000.0),
        device="cpu", **options)
    return model, TL.layered_initial_state(model, **init), TL.layered_step


_BUILT = {}


def built(kind):
    """``build(kind)`` after one step (nonzero tendencies, filled halos), made once."""
    if kind not in _BUILT:
        model, state, step = build(kind)
        _BUILT[kind] = (model, step(model, state, 60.0), step)
    return _BUILT[kind]


def _scaled(state, s):
    return type(state)(**{f.name: getattr(state, f.name) * s
                          if f.name not in ("t", "iteration") else getattr(state, f.name)
                          for f in dataclasses.fields(state)})


def case(kind, members):
    """(model, state, step): one member, or ``members`` members (the state times 0.5,
    1, 1.5, ...; the second one step ahead, so that t, iteration and the AB2 weights
    differ between members)."""
    model, state, step = built(kind)
    if members == 1:
        return model, state, step
    serial = [_scaled(state, 0.5 * (i + 1)) for i in range(members)]
    serial[1] = step(model, serial[1], 60.0)
    return model, ensemble.stack_members(serial), step


def zeros_like(state):
    return type(state)(**{f.name: torch.zeros_like(getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def assert_states_equal(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.device == y.device, f.name
        assert torch.equal(x, y), f.name


# --- serial directories ------------------------------------------------------------

@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("kind", ["single", "gyre", "front"])
def test_directory_round_trip(tmp_path, kind, members):
    """Every field, bitwise, into new tensors (``like`` is left as it was); a second
    save replaces the directory; no ``.tmp`` is left."""
    _, state, _ = case(kind, members)
    path = str(tmp_path / "ck")
    save_checkpoint(path, _scaled(state, 2.0))
    save_checkpoint(path, state)
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert ".metadata" in os.listdir(path)
    like = zeros_like(state)
    back = load_checkpoint(path, like)
    assert_states_equal(back, state)
    assert all(not torch.any(getattr(like, f.name)) for f in dataclasses.fields(like))
    assert back.t.shape == (() if members == 1 else (members,))


def test_directory_casts_to_like_as_orbax(tmp_path):
    """A float64 checkpoint read into a float32 ``like`` is cast to float32, as the
    JAX package's orbax route casts into its target: both give the same bits."""
    import jax.numpy as jnp

    from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH
    from orthogonalsphericalshellgrids_tpu.utils import checkpoint as JC

    _, state, _ = built("single")
    save_checkpoint(str(tmp_path / "dcp"), state)

    def f32(x):
        return x.float() if x.is_floating_point() else x

    like = type(state)(**{f.name: f32(getattr(state, f.name))
                          for f in dataclasses.fields(state)})
    back = load_checkpoint(str(tmp_path / "dcp"), like)
    jstate = JH.State(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                         for f in dataclasses.fields(state)})
    JC.save_checkpoint(str(tmp_path / "orbax"), jstate)
    jback = JC.load_checkpoint(str(tmp_path / "orbax"), JH.State(**{
        f.name: jnp.asarray(getattr(like, f.name).numpy())
        for f in dataclasses.fields(like)}))
    for f in dataclasses.fields(state):
        got, want = getattr(back, f.name), getattr(like, f.name)
        assert got.dtype == want.dtype and torch.equal(got, f32(getattr(state, f.name)))
        jgot = np.asarray(getattr(jback, f.name))
        assert jgot.dtype == got.numpy().dtype, f.name
        np.testing.assert_array_equal(jgot, got.numpy(), err_msg=f.name)


def test_directory_refuses_another_shape(tmp_path):
    """A field whose shape differs from the saved one raises ``ValueError`` naming
    it, as orbax does; so does a state of another class."""
    _, state, _ = built("single")
    path = str(tmp_path / "ck")
    save_checkpoint(path, state)
    like = dataclasses.replace(state, eta=torch.zeros(state.eta.shape[0] + 1,
                                                      state.eta.shape[1],
                                                      dtype=state.eta.dtype))
    with pytest.raises(ValueError, match=r"eta: shape .* not compatible"):
        load_checkpoint(path, like)
    _, layered, _ = built("gyre")
    with pytest.raises(ValueError, match="LayeredState has"):
        load_checkpoint(path, layered)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), state)


# --- sharded directories -----------------------------------------------------------

def sharded(kind, members, mesh_kind, model=None, state=None):
    """(step function, models, states) of ``case(kind, members)`` on ``mesh_kind``
    ranks through LocalExchange (a number of y-shards or an (n_x, n_y) mesh), after
    one sharded step."""
    if model is None:
        model, state, _ = case(kind, members)
    layered = kind != "single"
    if isinstance(mesh_kind, int):
        mesh = make_mesh(mesh_kind)
        dm, ds = (distribute_layered if layered else distribute)(model, state, mesh)
        fn = (sharded_layered_step_fn if layered else sharded_step_fn)(mesh, dm)
    else:
        mesh = make_mesh2d(*mesh_kind)
        dm, ds = (distribute_layered2d if layered else distribute2d)(model, state, mesh)
        fn = (sharded_layered_step_fn2d if layered else sharded_step_fn2d)(
            mesh, dm, model.grid.Nx)
    return fn, dm, fn(ds, 60.0)


class LoadSpy:
    """Records, for every DCP load, {key: the tensor it fills} and ``no_dist`` (one
    process's call, not a collective over the group)."""

    def __init__(self, monkeypatch=None):
        self.calls, self.no_dist = [], []
        self._load = dcp.load
        if monkeypatch is not None:
            monkeypatch.setattr(dcp, "load", self)
        else:
            dcp.load = self

    def __call__(self, state_dict, **kwargs):
        self.calls.append(dict(state_dict))
        self.no_dist.append(kwargs.get("no_dist", False))
        return self._load(state_dict, **kwargs)

    def field_keys(self):
        """{key: tensor} of the load of the fields (the last one)."""
        return self.calls[-1]


def check_own_keys(keys, back, dist_model):
    """Every key of the fields' load fills rank k's returned tensor only if it is
    ``rank<k>/<field>``, or is ``t`` or ``iteration`` (read once); every field of
    every rank was filled."""
    for key, tensor in keys.items():
        rank, _, name = key.rpartition("/")
        if rank:
            k = next(i for i, m in enumerate(dist_model) if f"rank{m.shard[0]}" == rank)
            assert getattr(back[k], name).data_ptr() == tensor.data_ptr(), key
        else:
            assert name in ("t", "iteration"), key
    for state, model in zip(back, dist_model):
        for f in dataclasses.fields(state):
            if f.name not in ("t", "iteration"):
                assert f"rank{model.shard[0]}/{f.name}" in keys


@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("mesh_kind", [2, 4, (2, 2)], ids=["y2", "y4", "2x2"])
@pytest.mark.parametrize("kind", ["single", "gyre"])
def test_sharded_directory_round_trip(tmp_path, monkeypatch, kind, mesh_kind, members):
    """One directory for all ranks (no per-rank files, no gather): read back into
    zeroed rank states bitwise, each rank's tensors filled from its own keys, and two
    more steps bitwise the uninterrupted run's."""
    fn, dm, s = sharded(kind, members, mesh_kind)
    path = str(tmp_path / "ck")
    save_sharded_checkpoint(path, s, dm)
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp"]
    spy = LoadSpy(monkeypatch)
    back = load_sharded_checkpoint(path, [zeros_like(x) for x in s], dm)
    check_own_keys(spy.field_keys(), back, dm)
    assert spy.no_dist[-1] is True
    for a, b in zip(s, back):
        assert_states_equal(b, a)
    for a, b in zip(fn(fn(s, 60.0), 60.0), fn(fn(back, 60.0), 60.0)):
        assert_states_equal(b, a)
    fn.close()


@pytest.mark.parametrize("other", [2, (2, 2), (4, 1)], ids=["y2", "2x2", "4x1"])
def test_sharded_directory_refuses_another_decomposition(tmp_path, other):
    """A directory written on 4 y-shards does not load onto another decomposition:
    ``ValueError`` naming the saved and the requested layout."""
    fn, dm, s = sharded("single", 1, 4)
    fn.close()
    path = str(tmp_path / "ck")
    save_sharded_checkpoint(path, s, dm)
    fn2, dm2, s2 = sharded("single", 1, other)
    fn2.close()
    with pytest.raises(ValueError, match=r"holds 4 ranks on an n_y x n_x = 4 x 1 mesh "
                                         r"of 12 x 32 blocks; the run has"):
        load_sharded_checkpoint(path, s2, dm2)
    save_checkpoint(str(tmp_path / "serial"), built("single")[1])
    with pytest.raises(ValueError, match="holds no decomposition"):
        load_sharded_checkpoint(str(tmp_path / "serial"), s, dm)


def test_sharded_directory_refuses_ranks_that_disagree(tmp_path):
    """t and iteration are written once: ranks whose t differ are refused."""
    fn, dm, s = sharded("single", 1, 2)
    fn.close()
    s[1] = dataclasses.replace(s[1], t=s[1].t + 1.0)
    with pytest.raises(ValueError, match="differ between rank 0 and rank 1"):
        save_sharded_checkpoint(str(tmp_path / "ck"), s, dm)
    assert not os.path.exists(tmp_path / "ck")


def _group_rank(rank, n, dist_model, dist_state, written, path):
    """A rank of a gloo group (``spawn``): read ``written`` (a LocalExchange
    directory) through ProcessGroupExchange, take one step, write ``path``. Returns
    (whether the read was bitwise the rank's state, the keys it loaded, whether it
    loaded them over the group, the stepped state as numpy)."""
    spy = LoadSpy()
    mesh = ProcessGroupExchange()
    model, state = dist_model[rank], dist_state[rank]
    back = load_sharded_checkpoint(written, [zeros_like(state)], [model])
    same = all(torch.equal(getattr(back[0], f.name), getattr(state, f.name))
               for f in dataclasses.fields(state))
    fn = ShardedStep(mesh, [model], TH.step)
    out = fn(back, 60.0)
    save_sharded_checkpoint(path, out, [model])
    return same, sorted(spy.field_keys()), not spy.no_dist[-1], {
        f.name: getattr(out[0], f.name).numpy() for f in dataclasses.fields(out[0])}


@pytest.fixture(scope="module")
def group_run(tmp_path_factory):
    """A 3-member jet on 2 y-shards: written by LocalExchange, read and stepped once
    by 2 processes of a gloo group, which write their own directory."""
    tmp = tmp_path_factory.mktemp("group")
    fn, dm, s = sharded("single", 3, 2)
    written, path = str(tmp / "local"), str(tmp / "group")
    save_sharded_checkpoint(written, s, dm)
    out = spawn(2, _group_rank, "gloo", args=(dm, s, written, path), timeout=120.0)
    want = fn(s, 60.0)
    fn.close()
    return dm, want, path, out


def test_group_reads_a_local_directory(group_run):
    """Each process of the group reads the directory LocalExchange wrote bitwise,
    loading only its own rank's keys (and t, iteration), and steps on as
    LocalExchange does."""
    dm, want, _, out = group_run
    for k, (same, keys, over_group, stepped) in enumerate(out):
        assert same and over_group, k
        fields = [f.name for f in dataclasses.fields(want[k])]
        assert keys == sorted([f"rank{k}/{n}" for n in fields if n not in
                               ("t", "iteration")] + ["iteration", "t"])
        for n in fields:
            np.testing.assert_array_equal(stepped[n], getattr(want[k], n).numpy(),
                                          err_msg=f"rank {k} {n}")


def test_local_reads_a_group_directory(group_run):
    """The directory the gloo group wrote (one data file a process) reads back
    through LocalExchange bitwise."""
    dm, want, path, _ = group_run
    assert sorted(os.listdir(path)) == [".metadata", "__0_0.distcp", "__1_0.distcp"]
    back = load_sharded_checkpoint(path, [zeros_like(x) for x in want], dm)
    for a, b in zip(want, back):
        assert_states_equal(b, a)


# --- Checkpointer and Simulation ---------------------------------------------------

def small():
    """``tests/test_utils.py:make`` in the port: a 32 x 24 float64 grid, substeps 8."""
    grid = TripolarGrid.make((32, 24, 1), dtype=torch.float64, device="cpu")
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=8),
                          device="cpu")
    return model, TH.initial_state(model, **U0)


def test_checkpointer_directories_pickup(tmp_path):
    """``Checkpointer(prefix, npz=False)`` writes ``{prefix}_iteration{N}``
    directories; a run resumed from iteration 3 and one resumed from the newest
    (``pickup=True``, iteration 6) are bitwise the uninterrupted run to 9."""
    model, state = small()
    prefix = str(tmp_path / "ck")
    ck = Checkpointer(prefix, npz=False)
    assert ck.path_for(3) == prefix + "_iteration3"
    assert Checkpointer(prefix).path_for(3) == prefix + "_iteration3.npz"
    sim = Simulation(model, state, dt=30.0, stop_iteration=6)
    sim.add_callback(ck, IterationInterval(3))
    sim.run()
    assert sorted(os.listdir(tmp_path)) == ["ck_iteration3", "ck_iteration6"]
    assert Checkpointer.latest(prefix) == prefix + "_iteration6"
    want = Simulation(model, state, dt=30.0, stop_iteration=9).run()
    for pickup in (ck.path_for(3), True):
        sim = Simulation(model, state, dt=30.0, stop_iteration=9)
        sim.add_callback(Checkpointer(str(tmp_path / "again"), npz=False),
                         IterationInterval(3))
        if pickup is True:
            sim.add_callback(ck, IterationInterval(100))
        got = sim.run(pickup=pickup)
        assert sim.iteration == 9
        assert_states_equal(got, want)


def test_latest_skips_unfinished_directories(tmp_path):
    """A directory still being written (``.tmp``) and one without ``.metadata`` are
    not picked: ``latest`` and ``pickup=True`` take the newest complete one."""
    model, state = small()
    prefix = str(tmp_path / "ck")
    ck = Checkpointer(prefix, npz=False)
    sim = Simulation(model, state, dt=30.0, stop_iteration=3)
    sim.add_callback(ck, IterationInterval(3))
    s3 = sim.run()
    save_checkpoint(prefix + "_iteration9", state)
    os.replace(prefix + "_iteration9", prefix + "_iteration9.tmp")
    save_checkpoint(prefix + "_iteration6", state)
    os.remove(os.path.join(prefix + "_iteration6", ".metadata"))
    assert Checkpointer.latest(prefix) == prefix + "_iteration3"
    sim = Simulation(model, state, dt=30.0, stop_iteration=3)
    sim.add_callback(ck, IterationInterval(100))
    assert_states_equal(sim.run(pickup=True), s3)
    shutil.rmtree(prefix + "_iteration3")
    assert Checkpointer.latest(prefix) is None


def test_unwritable_checkpoint_raises_through_run(tmp_path):
    """A checkpoint directory that cannot be made raises out of ``Simulation.run``;
    nothing falls back to npz."""
    model, state = small()
    (tmp_path / "file").write_bytes(b"x")
    sim = Simulation(model, state, dt=30.0, stop_iteration=3)
    sim.add_callback(Checkpointer(str(tmp_path / "file" / "ck"), npz=False),
                     IterationInterval(3))
    with pytest.raises(OSError):
        sim.run()
    assert sorted(os.listdir(tmp_path)) == ["file"]


def test_jet_resumed_by_both_packages(tmp_path):
    """The 48 x 32 float64 Bickley jet through each package's Simulation at dt = 60
    s, checkpointed at iteration 3 by ``Checkpointer(npz=False)`` (orbax in the JAX
    package, DCP here) and resumed to 6: each resumed run bitwise its own
    uninterrupted run, and the two within rtol 1e-12."""
    import jax.numpy as jnp

    from examples.bickley_jet import build as jax_build
    from orthogonalsphericalshellgrids_tpu.utils import simulation as JS

    ends = {}
    for pkg, sim_cls, ck_cls, make in (
            ("jax", JS.Simulation, JS.Checkpointer,
             lambda: jax_build(48, 32, dtype=jnp.float64)),
            ("torch", Simulation, Checkpointer,
             lambda: bickley_ex.build(48, 32, dtype=torch.float64, device="cpu"))):
        model, state = make()
        ck = ck_cls(str(tmp_path / pkg), npz=False)
        first = sim_cls(model, state, dt=60.0, stop_iteration=3)
        first.add_callback(ck, IterationInterval(3))
        first.run()
        assert os.path.isdir(ck.path_for(3))
        resumed = sim_cls(model, state, dt=60.0, stop_iteration=6)
        resumed.add_callback(ck, IterationInterval(100))
        got = resumed.run(pickup=True)
        want = sim_cls(model, state, dt=60.0, stop_iteration=6).run()
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                          np.asarray(getattr(want, f.name)),
                                          err_msg=f"{pkg} {f.name}")
        ends[pkg] = (model, got)
    jm, jout = ends["jax"]
    _, tout = ends["torch"]
    for f in dataclasses.fields(tout):
        want, got = np.asarray(getattr(jout, f.name)), getattr(tout, f.name).numpy()
        if want.ndim < 2:
            np.testing.assert_allclose(got, want, rtol=1e-14, err_msg=f.name)
            continue
        g = jm.grid_ext if f.name in ("eta", "U", "V") else jm.grid
        sl = (slice(g.Hy, g.Hy + g.Ny), slice(g.Hx, g.Hx + g.Nx))
        want, got = want[sl], got[sl]
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want).max(), 1e-300),
                                   err_msg=f.name)


# --- layout tags -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["single", "gyre"])
def test_classify_tree_matches_jax(kind):
    """The tag of every field of ``State`` and ``LayeredState``, as the JAX package's
    ``classify_tree`` gives it."""
    import jax.numpy as jnp

    from orthogonalsphericalshellgrids_tpu.models import hydrostatic as JH
    from orthogonalsphericalshellgrids_tpu.models import layered as JL
    from orthogonalsphericalshellgrids_tpu.parallel import layouts as JLay

    _, state, _ = built(kind)
    jcls = JH.State if kind == "single" else JL.LayeredState
    jstate = jcls(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                     for f in dataclasses.fields(state)})
    tags, jtags = classify_tree(state), JLay.classify_tree(jstate)
    assert type(tags) is type(state)
    for f in dataclasses.fields(state):
        assert getattr(tags, f.name) == getattr(jtags, f.name), f.name
    assert {getattr(tags, f.name) for f in dataclasses.fields(state)} == {
        "base", "ext", "rep"}
