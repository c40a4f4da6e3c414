"""Ensembles of sharded runs in the PyTorch port: a member batch (``models/ensemble.py:
stack_members``) distributed, stepped and gathered through the 1-D and 2-D
decompositions (``parallel/distributed.py``, ``parallel/distributed2d.py``), at
float64 on the CPU, with three members at different iterations (the second one step
ahead, so its AB2 weights differ from the others').

- against the JAX package's ``jax.vmap`` of its sharded steps: ``sharded_step_fn`` of
  ``tests/test_distributed.py:small_model`` on 4 virtual devices, 3 steps, rtol 1e-12,
  and ``sharded_layered_step_fn`` of the ``linear_eos`` config of
  ``tests/test_torch_layered.py`` on 2, Pallas in interpret mode as the JAX package's
  own tests run it, 2 steps, rtol 1e-11 (the bands of the serial comparisons: XLA:CPU
  contracts multiply-adds where eager PyTorch does not);
- member by member, bitwise, against each member's own sharded run: the single-layer
  ``OPTIONS`` of ``tests/test_torch_ensemble.py`` (the forcing that reads t included)
  and the layered gyre, linear-EOS and buoyancy cases of
  ``tests/test_torch_distributed.py:layered_case`` and the linear-EOS case with a
  forcing of T that reads t, in 2 and 4 y-shards and on 2 x 2 blocks, with the
  overlap split and without; the split hands the forcing each member's time as the
  unsplit step does (the two forcing cases fail where it hands the forcing the (B,)
  time);
- 2 processes of a gloo group (``spawn``, ``ProcessGroupExchange``) bitwise equal to
  ``LocalExchange``;
- a sharded ensemble's per-rank checkpoint resumed bitwise.
"""

import dataclasses
import functools
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

from test_torch_distributed import LAM_P, PHI_P, _land, layered_case  # noqa: E402
from test_torch_distributed import small_model  # noqa: E402
from test_torch_ensemble import OPTIONS  # noqa: E402
from test_torch_layered import CONFIGS, _jax_model, _state_numpy  # noqa: E402
from test_torch_layered import jax_layered_numpy  # noqa: E402

import orthogonalsphericalshellgrids_tpu as osg  # noqa: E402
from orthogonalsphericalshellgrids_tpu import models as JM  # noqa: E402
from orthogonalsphericalshellgrids_tpu.models import layered as JL  # noqa: E402
from orthogonalsphericalshellgrids_tpu.parallel import distributed as jdist  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import (  # noqa: E402
    SplitExplicitFreeSurface, ensemble)
from orthogonalsphericalshellgrids_tpu_torch.parallel import (  # noqa: E402
    distribute, distribute2d, distribute_layered, distribute_layered2d,
    gather_layered_state, gather_layered_state2d, gather_state, gather_state2d,
    make_mesh, make_mesh2d, run_steps, sharded_layered_step_fn,
    sharded_layered_step_fn2d, sharded_step_fn, sharded_step_fn2d, spawn)
from orthogonalsphericalshellgrids_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_sharded_checkpoint, save_sharded_checkpoint)

torch.set_num_threads(1)

SCALES = (0.5, 1.0, 1.5)


def _scaled(state, s):
    """The state with every field times ``s`` (t and iteration kept)."""
    return type(state)(**{f.name: getattr(state, f.name) * s
                          if f.name not in ("t", "iteration") else getattr(state, f.name)
                          for f in dataclasses.fields(state)})


def _members(model, base, dt, step):
    """Three serial members, the base state times 0.5, 1.0 and 1.5, the second one
    step ahead."""
    serial = [_scaled(base, s) for s in SCALES]
    serial[1] = step(model, serial[1], dt)
    return serial


# ----------------------------------------------------------------------------------
# against jax.vmap of the JAX package's sharded steps
# ----------------------------------------------------------------------------------

def _jax_batch(states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _assert_member_close(model, got, want, names, rtol):
    for name in names:
        grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
        w = np.asarray(getattr(want, name))[..., grid.interior2d[0], grid.interior2d[1]]
        np.testing.assert_allclose(grid.interior(getattr(got, name)).numpy(), w,
                                   rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=name)


def test_sharded_ensemble_matches_jax_vmap():
    """Three members of ``small_model`` (the second one JAX step ahead) in 4 shards,
    3 steps of 120 s: the port's gathered batch against the jitted ``jax.vmap`` of the
    JAX package's ``sharded_step_fn`` on 4 virtual devices, member by member, rtol
    1e-12. Both start from the JAX members' fields."""
    grid = osg.TripolarGrid.make((32, 48, 1), dtype=jnp.float64,
                                 first_pole_longitude=LAM_P, north_poles_latitude=PHI_P)
    jm = JM.make_model(grid, free_surface=JM.SplitExplicitFreeSurface(substeps=6),
                       bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, 0.0))
    js = JM.initial_state(
        jm, u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
        v=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 3) * np.cos(np.deg2rad(phi) * 2),
        c=lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0))
    serial = [jax.tree.map(lambda a, s=s: (a * s).astype(a.dtype)
                           if a.ndim > 0 else a, js) for s in SCALES]
    serial[1] = jax.jit(JM.step)(jm, serial[1], 120.0)
    n = 4
    jmesh = jdist.make_mesh(n)
    jdm = jdist.distribute(jm, js, jmesh)[0]
    jbatch = _jax_batch([jdist.distribute(jm, s, jmesh)[1] for s in serial])
    jfn = jdist.sharded_step_fn(jmesh, jdm)
    vstep = jax.jit(jax.vmap(lambda s: jfn(s, 120.0)))
    for _ in range(3):
        jbatch = vstep(jbatch)

    model = small_model()[0]
    batch = ensemble.stack_members([TH.state_from_numpy(
        {f.name: np.asarray(getattr(s, f.name)) for f in dataclasses.fields(s)}, "cpu")
        for s in serial])
    mesh = make_mesh(n)
    dist_model, ds = distribute(model, batch, mesh)
    fn = sharded_step_fn(mesh, dist_model)
    for _ in range(3):
        ds = fn(ds, 120.0)
    out = gather_state(ds, model, n)
    assert out.iteration.tolist() == [3, 4, 3]
    for i in range(len(SCALES)):
        want = jdist.gather_state(jax.tree.map(lambda x: x[i], jbatch), jm, n)
        _assert_member_close(model, ensemble.member(out, i), want,
                             ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc"), 1e-12)
        assert float(out.t[i]) == pytest.approx(float(want.t), rel=1e-15)


def test_sharded_layered_ensemble_matches_jax_vmap():
    """Three members of the ``linear_eos`` config (48 x 32 x 3; the second one JAX
    step ahead) in 2 shards, 2 steps of 90 s: the port's gathered batch against the
    jitted ``jax.vmap`` of the JAX package's ``sharded_layered_step_fn`` (Pallas in
    interpret mode), member by member, rtol 1e-11."""
    jm, js = _jax_model(CONFIGS["linear_eos"])
    serial = [jax.tree.map(lambda a, s=s: (a * s).astype(a.dtype)
                           if a.ndim > 0 else a, js) for s in SCALES]
    serial[1] = jax.jit(lambda m, s: JL.layered_step(m, s, 90.0, fill_mode="per"))(
        jm, serial[1])
    n = 2
    jmesh = jdist.make_mesh(n)
    jdm = jdist.distribute_layered(jm, js, jmesh)[0]
    jbatch = _jax_batch([jdist.distribute_layered(jm, s, jmesh)[1] for s in serial])
    jfn = jdist.sharded_layered_step_fn(jmesh, jdm)
    vstep = jax.jit(jax.vmap(lambda s: jfn(s, 90.0)))
    for _ in range(2):
        jbatch = vstep(jbatch)

    arrays, meta = jax_layered_numpy(jm)
    model = TL.layered_from_jax_arrays(arrays, meta, device="cpu")
    batch = ensemble.stack_members([TL.layered_state_from_numpy(_state_numpy(s), "cpu")
                                    for s in serial])
    mesh = make_mesh(n)
    dist_model, ds = distribute_layered(model, batch, mesh)
    fn = sharded_layered_step_fn(mesh, dist_model)
    for _ in range(2):
        ds = fn(ds, 90.0)
    out = gather_layered_state(ds, model, n)
    assert out.iteration.tolist() == [2, 3, 2]
    for i in range(len(SCALES)):
        want = jdist.gather_layered_state(jax.tree.map(lambda x: x[i], jbatch), jm, n)
        _assert_member_close(model, ensemble.member(out, i), want,
                             ("u", "v", "c", "b", "eta", "U", "V", "Gu", "Gv", "Gc"),
                             1e-11)


# ----------------------------------------------------------------------------------
# member by member against each member's own sharded run, bitwise
# ----------------------------------------------------------------------------------

def _forcing_T(lam, phi, z, t, fields):
    return 1e-7 * torch.sin(2e-4 * t) * torch.cos(torch.deg2rad(phi))


@functools.cache
def _case(case):
    """(model, base state, step, dt) of a case: ``small_model``'s grid and land with
    one of the single-layer ``OPTIONS``, or a layered case (32 x 48 x 3; ``eos_forcing``
    the ``eos`` case's model with a forcing of T that reads t); built once."""
    if case in OPTIONS:
        grid = small_model()[0].grid
        model = TH.make_model(
            grid, free_surface=SplitExplicitFreeSurface(substeps=6),
            bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, 0.0),
            device="cpu", **OPTIONS[case])
        base = TH.initial_state(
            model, u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
            v=lambda lam, phi: 0.05 * np.sin(np.deg2rad(lam) * 3),
            c=lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0))
        return model, base, TH.step, 60.0
    if case == "eos_forcing":
        eos, base = layered_case("eos")
        model = TL.make_layered_model(
            eos.grid, free_surface=SplitExplicitFreeSurface(substeps=6),
            bottom_height=lambda lam, phi: np.where(_land(lam, phi), 1.0, -1000.0),
            device="cpu", tracers=("T", "S"), buoyancy="linear_eos",
            forcing={"T": _forcing_T})
        return model, base, TL.layered_step, 60.0
    model, base = layered_case(case)
    return model, base, TL.layered_step, 60.0


def _run(model, state, mesh_kind, overlap, n_steps, dt):
    """``state`` (one member or a batch) distributed on ``mesh_kind`` (a number of
    y-shards or an (n_x, n_y) mesh), ``n_steps`` sharded steps, gathered."""
    layered = isinstance(model, TL.LayeredModel)
    if isinstance(mesh_kind, int):
        mesh = make_mesh(mesh_kind)
        dm, ds = (distribute_layered if layered else distribute)(model, state, mesh)
        fn = (sharded_layered_step_fn if layered else sharded_step_fn)(
            mesh, dm, overlap=overlap)
        gather = (gather_layered_state if layered else gather_state)
        arg = mesh_kind
    else:
        mesh = make_mesh2d(*mesh_kind)
        dm, ds = (distribute_layered2d if layered else distribute2d)(model, state, mesh)
        fn = (sharded_layered_step_fn2d if layered else sharded_step_fn2d)(
            mesh, dm, model.grid.Nx, overlap=overlap)
        gather = (gather_layered_state2d if layered else gather_state2d)
        arg = mesh
    try:
        for _ in range(n_steps):
            ds = fn(ds, dt)
    finally:
        fn.close()
    return gather(ds, model, arg)


@pytest.mark.parametrize("overlap", [None, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("mesh_kind", [2, 4, (2, 2)], ids=["y2", "y4", "2x2"])
@pytest.mark.parametrize("case", sorted(OPTIONS) + ["gyre", "eos", "eos_forcing",
                                                   "buoyancy"])
def test_sharded_ensemble_is_member_wise_bitwise(case, mesh_kind, overlap):
    """Three members, the second one step ahead, 3 sharded steps of the batch: every
    field of every member bitwise its own sharded run (``overlap=None`` is the split,
    on by default where it is exact)."""
    model, base, step, dt = _case(case)
    serial = _members(model, base, dt, step)
    out = _run(model, ensemble.stack_members(serial), mesh_kind, overlap, 3, dt)
    assert out.iteration.tolist() == [3, 4, 3]
    for i, s in enumerate(serial):
        want = _run(model, s, mesh_kind, overlap, 3, dt)
        got = ensemble.member(out, i)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name)), (i, f.name)


# ----------------------------------------------------------------------------------
# across processes; the checkpoint
# ----------------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["forcing", "gyre"])
def test_gloo_sharded_ensemble_matches_local(case):
    """2 processes of a gloo group (``spawn``, ``ProcessGroupExchange``) stepping a
    3-member batch 3 times, each rank's state bitwise the same shards stepped through
    ``LocalExchange``."""
    model, base, step, dt = _case(case)
    batch = ensemble.stack_members(_members(model, base, dt, step))
    layered = isinstance(model, TL.LayeredModel)
    mesh = make_mesh(2)
    dist_model, dist_state = (distribute_layered if layered else distribute)(
        model, batch, mesh)
    out = spawn(2, run_steps, "gloo", args=(dist_model, dist_state, dt, 3), timeout=120.0)
    fn = (sharded_layered_step_fn if layered else sharded_step_fn)(mesh, dist_model)
    s = dist_state
    for _ in range(3):
        s = fn(s, dt)
    fn.close()
    for k in range(2):
        for f in dataclasses.fields(s[k]):
            np.testing.assert_array_equal(out[k][f.name], getattr(s[k], f.name).numpy(),
                                          err_msg=f"rank {k} {f.name}")


def test_sharded_ensemble_checkpoint_resumes_bitwise(tmp_path):
    """A 4-shard ensemble's per-rank checkpoints (``save_sharded_checkpoint``) read
    back bitwise, and the resumed run steps on bitwise as the uninterrupted one."""
    model, base, step, dt = _case("forcing")
    mesh = make_mesh(4)
    dist_model, ds = distribute(model, ensemble.stack_members(
        _members(model, base, dt, step)), mesh)
    fn = sharded_step_fn(mesh, dist_model)
    s = fn(ds, dt)
    path = str(tmp_path / "ensemble.npz")
    save_sharded_checkpoint(path, s, dist_model)
    back = load_sharded_checkpoint(path, [type(x)(**{f.name: torch.zeros_like(
        getattr(x, f.name)) for f in dataclasses.fields(x)}) for x in s], dist_model)
    for a, b in zip(s, back):
        assert all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
        assert b.t.shape == (3,) and b.iteration.tolist() == [1, 2, 1]
    for a, b in zip(fn(fn(s, dt), dt), fn(fn(back, dt), dt)):
        assert all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    fn.close()
