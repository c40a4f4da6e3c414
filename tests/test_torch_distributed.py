"""The port's y-partitioned runs (``parallel/distributed.py``, ``ops/spmd.py``) at
float64 on the CPU, the 1-D tests of ``tests/test_distributed.py`` ported.

- the sharded steps against the port's serial steps, bitwise: the single-layer model
  (the JAX tests' ``small_model``: 32 x 48, substeps 6, masked poles) for n = 2 and 8
  and the layered model with buoyancy, with the multi-tracer linear EOS and with the
  gyre's closures, wind and drag, all through ``LocalExchange`` (n threads);
- one shard is the serial step, call for call and bit for bit;
- the geometries the JAX package refuses;
- the exchange round trip against the JAX package's ``fill_halos_spmd`` (and its
  batch and group forms) under ``shard_map`` on 4 virtual devices, bitwise: the
  port's functions of those names are the steps' ``fill_group`` on copies;
- the per-rank output stitched back (one run's ranks only), and a per-rank
  checkpoint resumed bitwise;
- the port's gathered sharded state against the JAX package's ``sharded_step_fn``
  within rtol 1e-12, the band of ``tests/test_torch_model.py`` (XLA:CPU contracts
  multiply-adds where eager PyTorch does not);
- gloo process groups of 2 and 4 processes (``spawn``), bitwise equal to
  ``LocalExchange``.
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
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import orthogonalsphericalshellgrids_tpu as osg  # noqa: E402
from orthogonalsphericalshellgrids_tpu import models as JM  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops import spmd as jspmd  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import CC as JCC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import CF as JCF  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import FC as JFC  # noqa: E402
from orthogonalsphericalshellgrids_tpu.ops.location import FF as JFF  # noqa: E402
from orthogonalsphericalshellgrids_tpu.parallel import distributed as jdist  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import halo_fill  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface)
from orthogonalsphericalshellgrids_tpu_torch.ops import spmd  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC, FF  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.parallel import (  # noqa: E402
    distribute, distribute_layered, gather_layered_state, gather_state, layouts,
    make_mesh, run_steps, sharded_layered_step_fn, sharded_step_fn, spawn)

torch.set_num_threads(1)

LAM_P, PHI_P = 45.0, 35.0


def _land(lam, phi):
    return (((np.abs(lam - LAM_P) < 12) & (np.abs(PHI_P - phi) < 12))
            | ((np.abs(lam - (LAM_P + 180.0)) < 12) & (np.abs(PHI_P - phi) < 12))
            | (phi < -78))


def small_model(ny=48, substeps=6):
    """``tests/test_distributed.py:small_model`` in the port."""
    grid = TripolarGrid.make((32, ny, 1), dtype=torch.float64, first_pole_longitude=LAM_P,
                             north_poles_latitude=PHI_P, device="cpu")
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=substeps),
                          bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, 0.0),
                          device="cpu")
    return model, TH.initial_state(
        model, u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
        v=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 3) * np.cos(np.deg2rad(phi) * 2),
        c=lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0))


def layered_case(case):
    """The layered models of ``tests/test_distributed.py`` (buoyancy; T/S with the
    linear EOS) and the gyre's check model (closures, wind, drag), 32 x 48 x 3."""
    if case == "gyre":
        from examples.wind_driven_ts_gyre_torch import CHECK_INIT, CHECK_OPTIONS
        opts, init = dict(CHECK_OPTIONS), dict(CHECK_INIT)
    elif case == "buoyancy":
        opts = dict(buoyancy=True)
        init = dict(u=lambda lam, phi, z: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
                    v=lambda lam, phi, z: 0.05 * np.sin(np.deg2rad(lam) * 3),
                    c=lambda lam, phi, z: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0),
                    b=lambda lam, phi, z: 1e-5 * z + 1e-4 * np.sin(np.deg2rad(lam)))
    else:
        opts = dict(tracers=("T", "S"), buoyancy="linear_eos")
        init = dict(u=lambda lam, phi, z: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
                    c={"T": lambda lam, phi, z: 10.0 + 5e-3 * z + np.sin(np.deg2rad(lam)),
                       "S": lambda lam, phi, z: 35.0 + 0.1 * np.cos(np.deg2rad(phi) * 2)})
    grid = TripolarGrid.make((32, 48, 3), dtype=torch.float64, z=(-1000.0, 0.0),
                             first_pole_longitude=LAM_P, north_poles_latitude=PHI_P,
                             device="cpu")
    model = TL.make_layered_model(
        grid, free_surface=SplitExplicitFreeSurface(substeps=6),
        bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, -1000.0),
        device="cpu", **opts)
    return model, TL.layered_initial_state(model, **init)


def _assert_interiors_equal(model, a, b, names):
    g, ge = model.grid, model.grid_ext
    for name in names:
        grid = ge if name in ("eta", "U", "V") else g
        np.testing.assert_array_equal(grid.interior(getattr(a, name)).numpy(),
                                      grid.interior(getattr(b, name)).numpy(), err_msg=name)


STATE = ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc")
LAYERED = ("u", "v", "c", "b", "eta", "U", "V", "Gu", "Gv", "Gc", "Gb")


@pytest.fixture(scope="module")
def small():
    return small_model()


# ----------------------------------------------------------------------------------
# sharded against serial, bitwise
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 8])
def test_sharded_matches_serial(small, n):
    """Five sharded steps (the exchanged fills, the fold on the top shard only, the
    exchange-free barotropic subcycle) equal five serial steps bit for bit on every
    interior point; the state handed in is left as it was."""
    model, state = small
    mesh = make_mesh(n)
    dist_model, dist_state = distribute(model, state, mesh)
    before = [[getattr(s, f.name).clone() for f in dataclasses.fields(s)]
              for s in dist_state]
    fn = sharded_step_fn(mesh, dist_model)
    s_serial, s_dist = state, dist_state
    for _ in range(5):
        s_serial = TH.step(model, s_serial, 120.0)
        s_dist = fn(s_dist, 120.0)
    _assert_interiors_equal(model, s_serial, gather_state(s_dist, model, n), STATE)
    for s, b in zip(dist_state, before):
        assert all(torch.equal(getattr(s, f.name), x)
                   for f, x in zip(dataclasses.fields(s), b))


@pytest.mark.parametrize("case,n", [("buoyancy", 4), ("eos", 4), ("eos", 2), ("gyre", 2),
                                    ("gyre", 4)])
def test_sharded_layered_matches_serial(case, n):
    """Three sharded layered steps equal three serial ones bit for bit: prognostic
    buoyancy, the (n·Nz)-plane T/S stack with the linear EOS, and the gyre's
    closures, wind and quadratic drag."""
    model, state = layered_case(case)
    mesh = make_mesh(n)
    dist_model, dist_state = distribute_layered(model, state, mesh)
    fn = sharded_layered_step_fn(mesh, dist_model)
    ss, ds = state, dist_state
    for _ in range(3):
        ss = TL.layered_step(model, ss, 60.0)
        ds = fn(ds, 60.0)
    _assert_interiors_equal(model, ss, gather_layered_state(ds, model, n), LAYERED)


def _recording(monkeypatch):
    """Record every fill wrapper call of ``ops/spmd.py`` as (name, role)."""
    calls = []
    for name in ("fill_halos_group", "restore_strips_group", "pack_strips"):
        real = getattr(halo_fill, name)

        def wrapper(*args, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("role", args[1] if _name == "pack_strips"
                                        else halo_fill.SINGLE)))
            return _real(*args, **kw)

        monkeypatch.setattr(halo_fill, name, wrapper)
    return calls


def test_one_shard_is_the_serial_step(small, monkeypatch):
    """With one shard the sharded step makes the serial step's calls, in order, and
    its bits."""
    model, state = small
    calls = _recording(monkeypatch)
    want = TH.multi_step(model, state, 120.0, 2)
    serial_calls = list(calls)
    calls.clear()
    mesh = make_mesh(1)
    dist_model, dist_state = distribute(model, state, mesh)
    fn = sharded_step_fn(mesh, dist_model)
    got = fn(fn(dist_state, 120.0), 120.0)
    assert calls == serial_calls
    assert serial_calls == [("fill_halos_group", halo_fill.SINGLE)] * 2 + [
        ("restore_strips_group", halo_fill.SINGLE)] + [
        ("fill_halos_group", halo_fill.SINGLE)] * 2 + [
        ("restore_strips_group", halo_fill.SINGLE)]
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got[0], f.name), getattr(want, f.name)), f.name


def test_sharded_step_calls_per_shard(small, monkeypatch):
    """A shard's step packs, exchanges and fills twice (state with save, then GU and
    GV) and restores once, in its role."""
    model, state = small
    mesh = make_mesh(4)
    dist_model, dist_state = distribute(model, state, mesh)
    fn = sharded_step_fn(mesh, dist_model)
    calls = _recording(monkeypatch)
    fn(dist_state, 120.0)
    roles = [halo_fill.BOTTOM, halo_fill.MIDDLE, halo_fill.MIDDLE, halo_fill.TOP]
    for name, per_role in (("pack_strips", 2), ("fill_halos_group", 2),
                           ("restore_strips_group", 1)):
        got = sorted(r for c, r in calls if c == name)
        assert got == sorted(roles * per_role), name


def test_a_failing_shard_releases_the_others(small):
    """When one shard's step raises, the others leave their exchange and the step
    raises the first shard's error (within the exchange's timeout); the mesh then
    steps as before, bitwise."""
    from orthogonalsphericalshellgrids_tpu_torch.parallel import ShardedStep

    model, state = small
    mesh = make_mesh(4)
    dist_model, dist_state = distribute(model, state, mesh)
    mesh.timeout = 30.0

    def step(m, s, dt, spmd=None):
        if spmd.rank == 2:
            raise ArithmeticError("shard 2 failed")
        return TH.step(m, s, dt, spmd=spmd)

    with pytest.raises(ArithmeticError, match="shard 2 failed"):
        ShardedStep(mesh, dist_model, step)(dist_state, 120.0)
    got = sharded_step_fn(mesh, dist_model)(dist_state, 120.0)
    _assert_interiors_equal(model, gather_state(got, model, 4),
                            TH.step(model, state, 120.0), STATE)


@pytest.mark.parametrize("case", ["not divisible", "below the extended halo"])
def test_distribute_refuses(small, case):
    model, state = small
    with pytest.raises(ValueError):
        distribute(model, state, make_mesh(5 if case == "not divisible" else 16))


def test_layouts_cover_every_tensor():
    """Every buffer of both models has a layout; a name no table holds raises."""
    model, state = layered_case("gyre")
    tags = layouts.check_module(model)
    assert tags["baro.baro_pack"] == layouts.EXT and tags["n_wet"] == layouts.BASE
    assert tags["baro.grid.z_f"] == layouts.REP and tags["baro.ib.mask_c"] == layouts.BASE
    assert all(layouts.leaf_layout(f.name) for f in dataclasses.fields(state))
    with pytest.raises(KeyError):
        layouts.leaf_layout("baro.not_a_field")


# ----------------------------------------------------------------------------------
# the exchange against the JAX package's, bitwise
# ----------------------------------------------------------------------------------

def _run_shards(n, fn):
    """``fn(spmd)`` on each of ``n`` ranks of one LocalExchange, each in its thread
    and its turn."""
    from concurrent.futures import ThreadPoolExecutor

    mesh = make_mesh(n)

    def run(k):
        with mesh.turn(k):
            return fn(spmd.Spmd(k, n, mesh))

    with ThreadPoolExecutor(n) as pool:
        futures = [pool.submit(run, k) for k in range(n)]
        return [f.result(timeout=60) for f in futures]


def _jax_sharded(fn, blocks, n):
    from jax.sharding import PartitionSpec as P

    mesh = jdist.make_mesh(n)
    run = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(None, "y", None),
                                out_specs=P(None, "y", None)))
    out = np.asarray(run(jnp.asarray(np.concatenate(blocks, axis=-2))))
    return np.split(out, n, axis=-2)


N, NXR, HX = 4, 8, 2
LOCS = [(CC, JCC, 1), (FC, JFC, -1), (CF, JCF, -1), (FF, JFF, 1)]


def _blocks(ny, Hy, K, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal((K, ny + 2 * Hy, NXR + 2 * HX)) for _ in range(N)]


@pytest.mark.parametrize("ny,Hy", [(6, 2), (3, 3)])
@pytest.mark.parametrize("loc", range(4))
def test_exchange_matches_jax(ny, Hy, loc):
    """``fill_halos_spmd`` on 4 ranks against the JAX package's under ``shard_map``,
    bitwise, also where the top rank's fold reads a received south row (ny = Hy)."""
    tloc, jloc, sign = LOCS[loc]
    blocks = _blocks(ny, Hy, 2, seed=loc)
    want = _jax_sharded(partial(jspmd.fill_halos_spmd, loc=jloc, sign=sign, Nx=NXR,
                                ny=ny, Hx=HX, Hy=Hy, spmd=jspmd.Spmd("y", N)), blocks, N)
    got = _run_shards(N, lambda s: spmd.fill_halos_spmd(
        torch.from_numpy(blocks[s.rank]), tloc, sign, NXR, ny, HX, Hy, s))
    for k in range(N):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"rank {k}")


def test_exchange_batch_and_groups_match_jax():
    """The batch (a location a plane) and group (a location a stack) forms against
    the JAX package's, bitwise."""
    ny, Hy = 6, 2
    blocks = _blocks(ny, Hy, 4, seed=7)
    locs = [(t, j, s) for t, j, s in LOCS]
    want = _jax_sharded(partial(jspmd.fill_halos_spmd_batch, locs=[j for _, j, _ in locs],
                                signs=[s for *_, s in locs], Nx=NXR, ny=ny, Hx=HX, Hy=Hy,
                                spmd=jspmd.Spmd("y", N)), blocks, N)
    got = _run_shards(N, lambda s: spmd.fill_halos_spmd_batch(
        torch.from_numpy(blocks[s.rank]), [t for t, _, _ in locs],
        [x for *_, x in locs], NXR, ny, HX, Hy, s))
    for k in range(N):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"batch rank {k}")

    def jgroups(S):
        return jnp.concatenate(jspmd.fill_halos_spmd_groups(
            [S[:1], S[1:3], S[3:]], [JFC, JCC, JCF], [-1, 1, -1], NXR, ny, HX, Hy,
            jspmd.Spmd("y", N)), axis=0)

    want = _jax_sharded(jgroups, blocks, N)
    got = _run_shards(N, lambda s: torch.cat(spmd.fill_halos_spmd_groups(
        [torch.from_numpy(blocks[s.rank][a:b]) for a, b in ((0, 1), (1, 3), (3, 4))],
        [FC, CC, CF], [-1, 1, -1], NXR, ny, HX, Hy, s)))
    for k in range(N):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=f"groups rank {k}")


def test_halo_exchange_roundtrip():
    """``tests/test_distributed.py:test_halo_exchange_roundtrip`` in the port: on a
    y-linear field the north and south halos hold the neighbours' interior rows,
    rank 0's south is zero-gradient and the top rank's north is folded."""
    n, ny, Nx, Hx, Hy = 4, 6, 8, 2, 2
    blocks = []
    for k in range(n):
        A = np.zeros((ny + 2 * Hy, Nx + 2 * Hx))
        A[Hy:Hy + ny, Hx:Hx + Nx] = np.arange(k * ny, (k + 1) * ny)[:, None]
        blocks.append(A)
    out = _run_shards(n, lambda s: spmd.fill_halos_spmd(
        torch.from_numpy(blocks[s.rank]), CC, 1, Nx, ny, Hx, Hy, s).numpy())
    for k, blk in enumerate(out):
        if k > 0:
            np.testing.assert_array_equal(blk[:Hy, Hx], np.arange(k * ny - Hy, k * ny))
        else:
            np.testing.assert_array_equal(blk[:Hy, Hx], [0, 0])
        if k < n - 1:
            np.testing.assert_array_equal(blk[Hy + ny:, Hx],
                                          np.arange((k + 1) * ny, (k + 1) * ny + Hy))
        else:
            np.testing.assert_array_equal(blk[Hy + ny:, Hx], [n * ny - 2, n * ny - 3])


# ----------------------------------------------------------------------------------
# output and checkpoints
# ----------------------------------------------------------------------------------

def test_per_shard_output_and_stitch(small, tmp_path):
    """One archive a rank holding its interior; ``FieldTimeSeries`` stitches them
    into the gathered state's interior."""
    from orthogonalsphericalshellgrids_tpu_torch.utils.output import (
        FieldTimeSeries, ShardedOutputWriter)

    model, state = small
    n = 4
    mesh = make_mesh(n)
    dist_model, dist_state = distribute(model, state, mesh)
    fn = sharded_step_fn(mesh, dist_model)
    base = str(tmp_path / "dist_run.npz")
    writer = ShardedOutputWriter(base, dist_model)
    s, times = dist_state, []
    for i in range(3):
        s = fn(s, 120.0)
        times.append(120.0 * (i + 1))
        writer.write(times[-1], {"c": [x.c for x in s], "eta": [x.eta for x in s]})
    assert not os.path.exists(base)
    assert all(os.path.exists(writer.rank_filename(k)) for k in range(n))
    assert FieldTimeSeries(writer.rank_filename(1), "c")[0].shape == (
        model.grid.Ny // n, model.grid.Nx)
    gathered = gather_state(s, model, n)
    for name, grid in (("c", model.grid), ("eta", model.grid_ext)):
        fts = FieldTimeSeries(base, name)
        np.testing.assert_allclose(fts.times, times)
        np.testing.assert_array_equal(fts[-1], grid.interior(getattr(gathered, name)).numpy())


def test_stitch_reads_one_run_of_rank_archives(small, tmp_path):
    """Archives another run left under the same name are not stitched in: after an
    8-rank run and a 4-rank run, ``FieldTimeSeries`` reads ranks 0-3 only (and no
    ``rank_old`` file); a missing rank, or a rank archive of another run, raises."""
    from orthogonalsphericalshellgrids_tpu_torch.utils.output import (
        FieldTimeSeries, ShardedOutputWriter, rank_filename)

    model, state = small
    base = str(tmp_path / "run.npz")
    for n in (8, 4):
        dist_model, dist_state = distribute(model, state, make_mesh(n))
        writer = ShardedOutputWriter(base, dist_model)
        for t in (60.0, 120.0):
            writer.write(t, {"c": [x.c for x in dist_state]})
    assert os.path.exists(writer.rank_filename(7))
    np.savez(str(tmp_path / "run.rank_old.npz"), c=np.zeros(3))
    fts = FieldTimeSeries(base, "c")
    np.testing.assert_array_equal(fts.times, [60.0, 120.0])
    assert fts.data.shape == (2, model.grid.Ny, model.grid.Nx)
    np.testing.assert_array_equal(fts[1], model.grid.interior(state.c).numpy())

    two = str(tmp_path / "two.npz")
    dist_model, dist_state = distribute(model, state, make_mesh(2))
    ShardedOutputWriter(two, dist_model).write(60.0, {"c": [x.c for x in dist_state]})
    os.replace(rank_filename(two, 1), writer.rank_filename(2))
    with pytest.raises(ValueError, match="records rank 1 of 2, not rank 2 of the 4"):
        FieldTimeSeries(base, "c")
    os.remove(writer.rank_filename(2))
    with pytest.raises(FileNotFoundError, match="rank2"):
        FieldTimeSeries(base, "c")


def test_sharded_checkpoint_resumes_bitwise(small, tmp_path):
    """Each rank's state written to its own checkpoint and read back is bitwise what
    was written, and steps on exactly as the uninterrupted run."""
    from orthogonalsphericalshellgrids_tpu_torch.utils.checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint)

    model, state = small
    mesh = make_mesh(4)
    dist_model, dist_state = distribute(model, state, mesh)
    fn = sharded_step_fn(mesh, dist_model)
    s = fn(dist_state, 120.0)
    path = str(tmp_path / "ckpt.npz")
    save_sharded_checkpoint(path, s, dist_model)
    back = load_sharded_checkpoint(path, [type(x)(**{f.name: torch.zeros_like(
        getattr(x, f.name)) for f in dataclasses.fields(x)}) for x in s], dist_model)
    for a, b in zip(s, back):
        assert all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    for a, b in zip(fn(fn(s, 120.0), 120.0), fn(fn(back, 120.0), 120.0)):
        assert all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))


# ----------------------------------------------------------------------------------
# against the JAX package's sharded step; across processes
# ----------------------------------------------------------------------------------

def test_sharded_matches_jax_sharded_step(small):
    """The port's gathered 4-shard state after 5 steps against the JAX package's
    ``sharded_step_fn`` on 4 virtual devices, rtol 1e-12."""
    model, state = small
    grid = osg.TripolarGrid.make((32, 48, 1), dtype=jnp.float64,
                                 first_pole_longitude=LAM_P, north_poles_latitude=PHI_P)
    jm = JM.make_model(grid, free_surface=JM.SplitExplicitFreeSurface(substeps=6),
                       bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, 0.0))
    js = JM.initial_state(
        jm, u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
        v=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 3) * np.cos(np.deg2rad(phi) * 2),
        c=lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0))
    n = 4
    jmesh = jdist.make_mesh(n)
    jdm, jds = jdist.distribute(jm, js, jmesh)
    jfn = jdist.sharded_step_fn(jmesh, jdm)
    mesh = make_mesh(n)
    dist_model, s = distribute(model, state, mesh)
    fn = sharded_step_fn(mesh, dist_model)
    for _ in range(5):
        jds = jfn(jds, 120.0)
        s = fn(s, 120.0)
    want = jdist.gather_state(jds, jm, n)
    got = gather_state(s, model, n)
    for name in STATE:
        grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
        w = np.asarray(getattr(want, name))[..., grid.interior2d[0], grid.interior2d[1]]
        np.testing.assert_allclose(grid.interior(getattr(got, name)).numpy(), w,
                                   rtol=1e-12, atol=1e-12 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_process_group_matches_local(small, n):
    """``n`` processes of a gloo group (``spawn``, ``ProcessGroupExchange``), 3
    steps, bitwise equal to the same shards stepped through ``LocalExchange``."""
    model, state = small
    mesh = make_mesh(n)
    dist_model, dist_state = distribute(model, state, mesh)
    out = spawn(n, run_steps, "gloo", args=(dist_model, dist_state, 120.0, 3),
                timeout=120.0)
    fn = sharded_step_fn(mesh, dist_model)
    s = dist_state
    for _ in range(3):
        s = fn(s, 120.0)
    for k in range(n):
        for f in dataclasses.fields(s[k]):
            np.testing.assert_array_equal(out[k][f.name], getattr(s[k], f.name).numpy(),
                                          err_msg=f"rank {k} {f.name}")


def test_distributed_example_runs(tmp_path):
    """``examples/distributed_bickley_jet_torch.py`` with 4 local shards on the CPU:
    finite speeds and one archive a rank, stitched to the global interior."""
    from examples.distributed_bickley_jet_torch import main
    from orthogonalsphericalshellgrids_tpu_torch.utils.output import FieldTimeSeries

    out = str(tmp_path / "jet.npz")
    main(["--nx", "64", "--ny", "88", "--ranks", "4", "--steps", "50", "--device", "cpu",
          "--output", out])
    assert all(os.path.exists(str(tmp_path / f"jet.rank{k}.npz")) for k in range(4))
    c = FieldTimeSeries(out, "c")
    assert c.data.shape == (1, 88, 64) and np.isfinite(c.data).all()
