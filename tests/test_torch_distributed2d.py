"""The port's 2-D (x, y) runs (``parallel/distributed2d.py``, ``ops/spmd2d.py``) and
the interior/boundary overlap split (``models/hydrostatic.py:split_tendencies``) at
float64 on the CPU, the tests of ``tests/test_distributed2d.py`` ported.

- both models on 2-D meshes against the port's serial steps, bitwise, in the
  configurations of ``tests/test_distributed2d.py:46-180`` (the 48 x 32 jet with
  masked poles; the layered model with buoyancy, with the T/S linear EOS and
  forcing, and the gyre's closures, wind and drag), through ``LocalExchange``;
- the mirror fold bitwise equal to the gather;
- the split bitwise equal to the unsplit step on the 1-D and the 2-D meshes, both
  models;
- the port's gathered state against the JAX package's ``sharded_step_fn2d`` on the
  virtual devices within rtol 1e-12, the band of ``tests/test_torch_distributed.py``;
- a gloo group of 4 processes (2 x 2) bitwise equal to ``LocalExchange``;
- the fill calls a block makes, and a failing block that leaves every block's state
  as it was;
- the refusals: geometry, fold mode, and ``overlap=True`` where it is not exact;
- ``examples/distributed_bickley_jet_torch.py --decomp 2d``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import orthogonalsphericalshellgrids_tpu as osg  # noqa: E402
from orthogonalsphericalshellgrids_tpu import models as JM  # noqa: E402
from orthogonalsphericalshellgrids_tpu.parallel import distributed2d as jdist2d  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.parallel import (  # noqa: E402
    ShardedStep, distribute, distribute2d, distribute_layered, distribute_layered2d,
    gather_layered_state, gather_layered_state2d, gather_state, gather_state2d,
    make_mesh, make_mesh2d, run_steps, sharded_layered_step_fn,
    sharded_layered_step_fn2d, sharded_step_fn, sharded_step_fn2d, spawn)

torch.set_num_threads(1)

LAM_P, PHI_P = 45.0, 35.0
STATE = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")
LAYERED = ("u", "v", "c", "b", "eta", "U", "V", "Gu", "Gv", "Gc", "Gb")


def _land(lam, phi):
    return (((np.abs(lam - LAM_P) < 12) & (np.abs(PHI_P - phi) < 12))
            | ((np.abs(lam - (LAM_P + 180.0)) < 12) & (np.abs(PHI_P - phi) < 12))
            | (phi < -78))


U0 = (lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2)
V0 = (lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 3) * np.cos(np.deg2rad(phi) * 2))
C0 = (lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0))


def model_2d(halo=(4, 4, 4), substeps=6):
    """``tests/test_distributed2d.py:model_2d`` in the port: 48 x 32, substeps 6."""
    grid = TripolarGrid.make((48, 32, 1), dtype=torch.float64, halo=halo,
                             first_pole_longitude=LAM_P, north_poles_latitude=PHI_P,
                             device="cpu")
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
                          bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, 0.0),
                          device="cpu")
    return model, TH.initial_state(model, u=U0, v=V0, c=C0)


def layered_2d(case):
    """The layered models of ``tests/test_distributed2d.py`` at 48 x 32 x 3:
    buoyancy; T/S with the linear EOS and a relaxation forcing; the split test's
    T/S with Coriolis and ν_v; and the gyre's check options (closures, wind,
    drag)."""
    z = (-1000.0, 0.0)
    if case == "gyre":
        from examples.wind_driven_ts_gyre_torch import CHECK_INIT, CHECK_OPTIONS
        opts, init = dict(CHECK_OPTIONS), dict(CHECK_INIT)
    elif case == "buoyancy":
        opts = dict(buoyancy=True)
        init = dict(u=lambda lam, phi, z: U0(lam, phi),
                    v=lambda lam, phi, z: 0.05 * np.sin(np.deg2rad(lam) * 3),
                    c=lambda lam, phi, z: C0(lam, phi),
                    b=lambda lam, phi, z: 1e-5 * z + 1e-4 * np.sin(np.deg2rad(lam)))
    elif case == "eos":
        z = [-1000.0, -600.0, -250.0, 0.0]
        opts = dict(tracers=("T", "S"), buoyancy="linear_eos",
                    forcing={"T": lambda lam, phi, z, t, f: -(f.c[:3] - 10.0) / 7200.0})
        init = dict(u=lambda lam, phi, z: U0(lam, phi),
                    c={"T": lambda lam, phi, z: 10.0 + 5e-3 * z + np.sin(np.deg2rad(lam)),
                       "S": lambda lam, phi, z: 35.0 + 0.1 * np.cos(np.deg2rad(phi) * 2)})
    else:  # "split": tests/test_distributed2d.py:test_2d_layered_overlap_split_bitwise
        z = (-900.0, 0.0)
        opts = dict(tracers=("T", "S"), buoyancy="linear_eos", coriolis=True, nu_v=1e-4)
        init = dict(u=lambda lam, phi, z: U0(lam, phi),
                    v=lambda lam, phi, z: 0.05 * np.sin(np.deg2rad(lam) * 3),
                    c={"T": lambda lam, phi, z: 10.0 + 1e-2 * z,
                       "S": lambda lam, phi, z: 35.0 + np.sin(np.deg2rad(lam))})
    grid = TripolarGrid.make((48, 32, 3), dtype=torch.float64, z=z,
                             first_pole_longitude=LAM_P, north_poles_latitude=PHI_P,
                             device="cpu")
    bottom = z[0] if isinstance(z, tuple) else -1000.0
    model = TL.make_layered_model(
        grid, free_surface=SplitExplicitFreeSurface(substeps=6),
        bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, bottom),
        device="cpu", **opts)
    return model, TL.layered_initial_state(model, **init)


def _assert_interiors_equal(model, a, b, names):
    g, ge = model.grid, model.grid_ext
    for name in names:
        grid = ge if name in ("eta", "U", "V") else g
        np.testing.assert_array_equal(grid.interior(getattr(a, name)).numpy(),
                                      grid.interior(getattr(b, name)).numpy(), err_msg=name)


def _snapshot(states):
    return [[getattr(s, f.name).clone() for f in dataclasses.fields(s)] for s in states]


def _unchanged(states, snap):
    return all(torch.equal(getattr(s, f.name), x) for s, b in zip(states, snap)
               for f, x in zip(dataclasses.fields(s), b))


@pytest.fixture(scope="module")
def jet():
    return model_2d()


# ----------------------------------------------------------------------------------
# 2-D against serial, bitwise
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [(2, 4), (4, 2), (8, 1), (3, 1)])
def test_2d_matches_serial(jet, mesh):
    """Four 2-D sharded steps (the y rows, the fold across x-ranks, the x ring, the
    split) equal four serial steps bit for bit on every interior point; the states
    handed in are left as they were."""
    model, state = jet
    m = make_mesh2d(*mesh)
    dist_model, dist_state = distribute2d(model, state, m)
    snap = _snapshot(dist_state)
    fn = sharded_step_fn2d(m, dist_model, model.grid.Nx)
    ss, ds = state, dist_state
    for _ in range(4):
        ss = TH.step(model, ss, 120.0)
        ds = fn(ds, 120.0)
    _assert_interiors_equal(model, ss, gather_state2d(ds, model, m), STATE)
    assert _unchanged(dist_state, snap)


@pytest.mark.parametrize("case,mesh", [("buoyancy", (2, 4)), ("buoyancy", (4, 2)),
                                       ("eos", (2, 4)), ("gyre", (2, 2))])
def test_2d_layered_matches_serial(case, mesh):
    """Three 2-D sharded layered steps equal three serial ones bit for bit:
    prognostic buoyancy, the T/S stack with the linear EOS and forcing, and the
    gyre's closures, wind and quadratic drag."""
    model, state = layered_2d(case)
    m = make_mesh2d(*mesh)
    dist_model, dist_state = distribute_layered2d(model, state, m)
    fn = sharded_layered_step_fn2d(m, dist_model, model.grid.Nx)
    ss, ds = state, dist_state
    for _ in range(3):
        ss = TL.layered_step(model, ss, 60.0)
        ds = fn(ds, 60.0)
    _assert_interiors_equal(model, ss, gather_layered_state2d(ds, model, m), LAYERED)


@pytest.mark.parametrize("mode", ["gather", "mirror"])
def test_2d_blocks_of_the_extended_halo(mode):
    """Blocks of as many rows as the extended halo (ny = 8 at substeps 10), the
    least the JAX package takes: the top blocks' fold strips reach a received south
    row, read from the blocks below them. Two steps bitwise the serial ones."""
    model, state = model_2d(substeps=10)
    assert model.grid_ext.Hy == 8
    m = make_mesh2d(2, 4)
    dist_model, dist_state = distribute2d(model, state, m)
    fn = sharded_step_fn2d(m, dist_model, model.grid.Nx, fold_mode=mode)
    ds = fn(fn(dist_state, 60.0), 60.0)
    _assert_interiors_equal(model, TH.multi_step(model, state, 60.0, 2),
                            gather_state2d(ds, model, m), STATE)


def test_mirror_fold_step_matches_gather_and_serial(jet):
    """Two steps on a 4 x 2 mesh with the mirror fold: bitwise the gather's and the
    serial steps'."""
    model, state = jet
    m = make_mesh2d(4, 2)
    dist_model, dist_state = distribute2d(model, state, m)
    out = {}
    for mode in ("gather", "mirror"):
        fn = sharded_step_fn2d(m, dist_model, model.grid.Nx, fold_mode=mode)
        ds = dist_state
        for _ in range(2):
            ds = fn(ds, 60.0)
        out[mode] = gather_state2d(ds, model, m)
    _assert_interiors_equal(model, out["gather"], out["mirror"], STATE)
    _assert_interiors_equal(model, TH.multi_step(model, state, 60.0, 2), out["mirror"],
                            STATE)


# ----------------------------------------------------------------------------------
# the overlap split
# ----------------------------------------------------------------------------------

def _runs(model, state, mesh):
    """(distribute, step function of overlap, gather) of a model on a 1-D mesh of
    ``mesh`` shards or a 2-D mesh ``mesh``."""
    layered = isinstance(model, TL.LayeredModel)
    if isinstance(mesh, int):
        m = make_mesh(mesh)
        dm, ds = (distribute_layered if layered else distribute)(model, state, m)
        fn = sharded_layered_step_fn if layered else sharded_step_fn
        gather = gather_layered_state if layered else gather_state
        return ds, (lambda ov: fn(m, dm, overlap=ov)), (lambda s: gather(s, model, mesh))
    m = make_mesh2d(*mesh)
    dm, ds = (distribute_layered2d if layered else distribute2d)(model, state, m)
    fn = sharded_layered_step_fn2d if layered else sharded_step_fn2d
    gather = gather_layered_state2d if layered else gather_state2d
    return ds, (lambda ov: fn(m, dm, model.grid.Nx, overlap=ov)), (lambda s: gather(s, model, m))


@pytest.mark.parametrize("which,mesh", [("jet", 4), ("jet", (2, 4)), ("jet", (4, 2)),
                                        ("split", 4), ("split", (2, 4)),
                                        ("gyre", (2, 2))])
def test_overlap_split_bitwise(jet, which, mesh):
    """The split (bulk pass on the rank's own fields, launched before the exchange;
    the boundary rows, and on a 2-D mesh the columns, recomputed on strips of the
    filled fields) is bitwise the unsplit step, and the default on a sharded run,
    on both meshes and both models (the layered 2-D split too, which the JAX
    package holds only to rtol 1e-13 on XLA:CPU)."""
    model, state = jet if which == "jet" else layered_2d(which)
    names = STATE if which == "jet" else LAYERED
    ds, fn, gather = _runs(model, state, mesh)
    out = {}
    for overlap in (True, False, None):
        s = ds
        for _ in range(3):
            s = fn(overlap)(s, 60.0)
        out[overlap] = gather(s)
    _assert_interiors_equal(model, out[True], out[False], names)
    _assert_interiors_equal(model, out[True], out[None], names)


def test_one_shard_takes_no_split(jet):
    """One shard is the serial step: the split is off by default, and asking for it
    is refused."""
    model, state = jet
    m = make_mesh2d(1, 1)
    dist_model, dist_state = distribute2d(model, state, m)
    got = sharded_step_fn2d(m, dist_model, model.grid.Nx)(dist_state, 60.0)
    _assert_interiors_equal(model, TH.step(model, state, 60.0), got[0], STATE)
    with pytest.raises(ValueError, match="one shard"):
        sharded_step_fn2d(m, dist_model, model.grid.Nx, overlap=True)(dist_state, 60.0)


# ----------------------------------------------------------------------------------
# calls, failures, refusals
# ----------------------------------------------------------------------------------

def _recording(monkeypatch):
    calls = []
    for name in ("fill_halos_group", "restore_strips_group", "pack_strips"):
        real = getattr(halo_fill, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("phase", args[2] if _name == "pack_strips" and
                                        len(args) > 2 else None)))
            return _real(*args, **kw)

        monkeypatch.setattr(halo_fill, name, wrapper)
    return calls


def test_block_step_calls(jet, monkeypatch):
    """A block's step fills two groups (the state with save, then GU and GV), each
    with a pack of rows, the inner phase, a pack of columns and the outer phase, and
    restores once; it wraps nothing locally."""
    model, state = jet
    m = make_mesh2d(2, 2)
    dist_model, dist_state = distribute2d(model, state, m)
    fn = sharded_step_fn2d(m, dist_model, model.grid.Nx)
    calls = _recording(monkeypatch)
    fn(dist_state, 60.0)
    count = {c: calls.count(c) for c in set(calls)}
    assert count == {("pack_strips", None): 4 * 2, ("pack_strips", halo_fill.COLUMNS): 4 * 2,
                     ("fill_halos_group", halo_fill.INNER): 4 * 2,
                     ("fill_halos_group", halo_fill.OUTER): 4 * 2,
                     ("restore_strips_group", halo_fill.ALL): 4}, count


def test_a_failing_block_leaves_the_states(jet, monkeypatch):
    """When one block fails in its x exchange, after every block has written its
    inner phase, each block undoes what it wrote: every state is bitwise as it was,
    the step raises the block's error, and the mesh then steps as before."""
    from orthogonalsphericalshellgrids_tpu_torch.parallel import LocalExchange

    model, state = jet
    m = make_mesh2d(2, 2)
    m.timeout = 30.0
    dist_model, dist_state = distribute2d(model, state, m)
    snap = _snapshot(dist_state)
    real = LocalExchange.cols2d

    def cols2d(self, spmd, send, col_len):
        if spmd.rank == 3:
            raise ArithmeticError("block 3 failed")
        return real(self, spmd, send, col_len)

    monkeypatch.setattr(LocalExchange, "cols2d", cols2d)
    with pytest.raises(ArithmeticError, match="block 3 failed"):
        sharded_step_fn2d(m, dist_model, model.grid.Nx)(dist_state, 60.0)
    assert _unchanged(dist_state, snap)
    monkeypatch.setattr(LocalExchange, "cols2d", real)
    got = sharded_step_fn2d(m, dist_model, model.grid.Nx)(dist_state, 60.0)
    _assert_interiors_equal(model, gather_state2d(got, model, m),
                            TH.step(model, state, 60.0), STATE)
    assert isinstance(sharded_step_fn2d(m, dist_model, 48), ShardedStep)


@pytest.mark.parametrize("case", ["x not divisible", "y not divisible", "narrow block",
                                  "low block", "fold mode"])
def test_2d_refuses(jet, case):
    model, state = jet
    mesh = {"x not divisible": (5, 1), "y not divisible": (1, 3), "narrow block": (16, 1),
            "low block": (1, 8), "fold mode": (2, 2)}[case]
    if case == "fold mode":
        m = make_mesh2d(*mesh)
        dist_model, _ = distribute2d(model, state, m)
        with pytest.raises(ValueError, match="fold_mode"):
            sharded_step_fn2d(m, dist_model, 48, fold_mode="scatter")
        return
    with pytest.raises(ValueError):
        distribute2d(model, state, make_mesh2d(*mesh))


@pytest.mark.parametrize("mesh", [4, (2, 2)])
def test_overlap_true_refused_where_not_exact(mesh):
    """On a halo of 3 the split is not exact (the stencil radius 3 needs Hy >= 4):
    ``overlap=True`` raises, and the default runs the unsplit step, bitwise the
    serial one."""
    model, state = model_2d(halo=(3, 3, 3))
    assert not TH.overlap_supported(model, model.grid)
    ds, fn, gather = _runs(model, state, mesh)
    with pytest.raises(ValueError, match="not exact"):
        fn(True)(ds, 60.0)
    _assert_interiors_equal(model, TH.step(model, state, 60.0), gather(fn(None)(ds, 60.0)),
                            STATE)


# ----------------------------------------------------------------------------------
# against the JAX package; across processes; the example
# ----------------------------------------------------------------------------------

def test_2d_matches_jax_sharded_step(jet):
    """The port's gathered 2 x 4 state after 4 steps against the JAX package's
    ``sharded_step_fn2d`` on 8 virtual devices, rtol 1e-12."""
    model, state = jet
    grid = osg.TripolarGrid.make((48, 32, 1), dtype=jnp.float64,
                                 first_pole_longitude=LAM_P, north_poles_latitude=PHI_P)
    jm = JM.make_model(grid, free_surface=JM.SplitExplicitFreeSurface(substeps=6),
                       bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, 0.0))
    js = JM.initial_state(jm, u=U0, v=V0, c=C0)
    jmesh = jdist2d.make_mesh2d(2, 4)
    jdm, jds = jdist2d.distribute2d(jm, js, jmesh)
    jfn = jdist2d.sharded_step_fn2d(jmesh, jdm, 48)
    m = make_mesh2d(2, 4)
    dist_model, s = distribute2d(model, state, m)
    fn = sharded_step_fn2d(m, dist_model, 48)
    for _ in range(4):
        jds = jfn(jds, 120.0)
        s = fn(s, 120.0)
    want = jdist2d.gather_state2d(jds, jm, jmesh)
    got = gather_state2d(s, model, m)
    for name in ("u", "v", "c", "eta", "U", "V"):
        grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
        w = np.asarray(getattr(want, name))[grid.interior2d]
        np.testing.assert_allclose(grid.interior(getattr(got, name)).numpy(), w,
                                   rtol=1e-12, atol=1e-12 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("substeps", [6, 21])
def test_gloo_2x2_matches_local(jet, substeps):
    """4 processes of a gloo group (``spawn``, ``ProcessGroupExchange`` of shape
    (2, 2)), 3 steps of the jet, bitwise equal to the blocks stepped through
    ``LocalExchange``; at substeps 21 the blocks have as many rows as the extended
    halo (16), so the top blocks also receive the rows below their fold strips."""
    model, state = jet if substeps == 6 else model_2d(substeps=substeps)
    m = make_mesh2d(2, 2)
    dist_model, dist_state = distribute2d(model, state, m)
    out = spawn(4, run_steps, "gloo", timeout=120.0,
                args=(dist_model, dist_state, 120.0, 3, (2, 2, 48, "auto")))
    fn = sharded_step_fn2d(m, dist_model, 48)
    s = dist_state
    for _ in range(3):
        s = fn(s, 120.0)
    for k in range(4):
        for f in dataclasses.fields(s[k]):
            np.testing.assert_array_equal(out[k][f.name], getattr(s[k], f.name).numpy(),
                                          err_msg=f"rank {k} {f.name}")


def test_distributed_example_2d(tmp_path):
    """``examples/distributed_bickley_jet_torch.py --decomp 2d`` with 2 x 2 local
    blocks on the CPU: finite speeds; per-rank output is the 1-D decomposition's."""
    from examples.distributed_bickley_jet_torch import main

    lines = []
    main(["--nx", "64", "--ny", "88", "--ranks", "2", "--ndev-x", "2", "--decomp", "2d",
          "--steps", "50", "--device", "cpu"], log=lines.append)
    assert "2 x 2 blocks" in lines[-1] and "nan" not in lines[-1]
    with pytest.raises(SystemExit):
        main(["--decomp", "2d", "--ndev-x", "2", "--ranks", "2", "--device", "cpu",
              "--output", str(tmp_path / "jet.npz")])
