"""2-D (x, y) distributed runs of both models.

Counterpart: ``orthogonalsphericalshellgrids_tpu/parallel/distributed2d.py``
(``make_mesh2d``, ``distribute2d``, ``gather_state2d``, ``sharded_step_fn2d`` and their
layered counterparts). The reference never partitions x
(``src/distributed_tripolar_grid.jl:30-31``); here block (kx, ky) of an (n_x, n_y)
mesh holds rows ``[ky·ny, ky·ny + ny + 2·Hy)`` and columns ``[kx·nx, kx·nx + nx +
2·Hx)`` of every base- or extended-halo tensor (``parallel/layouts.py``), with the
local ``Nx = nx`` and ``Ny = ny``, and is a model of its own, built by the models'
constructors from the sliced planes as ``parallel/distributed.py`` builds its row
bands. The step on a block is the serial step with its fills exchanged through
``ops/spmd2d.py`` (the y rows and the fold strips, then the x columns), and by
default its tendencies split (``models/hydrostatic.py:split_tendencies``). The
barotropic subcycle needs no exchange inside its loop: the free-surface grid's
x halo is at least the substeps plus one, so the step runs it with the wrap off and
its validity shrinks into the halo in x as in y.

The meshes are ``parallel/distributed.py``'s exchanges over ranks ``ky·n_x + kx``:
``make_mesh2d`` gives the ``LocalExchange`` of all blocks in this process (threads
in turns, on one card or on the CPU); a process of a ``torch.distributed`` group
holds one block through ``ProcessGroupExchange(shape=(n_y, n_x))``
(``distributed.run_steps`` with ``mesh2d``).

Geometries the JAX package refuses are refused (``_check_divisibility``): ``Nx %
n_x``, ``Ny % n_y`` and a block smaller than the extended halos. The fold of an
x-block reads Hy + 1 rows of the top blocks, so one row of several x-blocks also
needs ny > Hy of the extended grid (with several rows of blocks the lowest of those
rows comes from the row below).
"""

from __future__ import annotations

import functools

from ..models import hydrostatic, layered
from ..ops.spmd2d import Spmd2D
from .distributed import LocalExchange, ShardedStep, _blocks, _gather_blocks
from .distributed import _shard_hydrostatic, _shard_layered

__all__ = ["make_mesh2d", "distribute2d", "gather_state2d", "sharded_step_fn2d",
           "distribute_layered2d", "gather_layered_state2d", "sharded_layered_step_fn2d"]


def make_mesh2d(n_x: int, n_y: int) -> LocalExchange:
    """The (``n_x``, ``n_y``) mesh of blocks stepped in this process."""
    if n_x < 1 or n_y < 1:
        raise ValueError(f"a mesh needs at least one rank a direction, got ({n_x}, {n_y})")
    return LocalExchange(n_x * n_y, shape=(n_y, n_x))


def _check_divisibility(g, ge, n_y, n_x):
    """(ny, nx) of the blocks, checked as the JAX package checks them
    (``distributed2d.py:62-69``), and the fold strip of an x-block."""
    if g.Ny % n_y or g.Nx % n_x:
        raise ValueError(f"grid {g.Nx}x{g.Ny} not divisible by mesh {n_x}x{n_y}")
    ny, nx = g.Ny // n_y, g.Nx // n_x
    if nx < ge.Hx or ny < ge.Hy:
        raise ValueError(
            f"local block {nx}x{ny} must cover the extended halos {ge.Hx}x{ge.Hy}")
    if n_x > 1 and n_y == 1 and ny <= ge.Hy:
        raise ValueError(
            f"local block {nx}x{ny}: the fold of one row of x-blocks reads Hy + 1 = "
            f"{ge.Hy + 1} interior rows")
    return ny, nx


def _distribute2d(model, state, mesh, shard_model):
    n_y, n_x = mesh.shape
    ny, nx = _check_divisibility(model.grid, model.grid_ext, n_y, n_x)
    return _blocks(model, state, mesh, shard_model, ny, nx, n_x)


def distribute2d(model, state, mesh):
    """The blocks of a serial single-layer ``model`` and ``state`` that this process
    holds: (list of models, list of states) in rank order, on the serial model's
    device."""
    return _distribute2d(model, state, mesh, _shard_hydrostatic)


def distribute_layered2d(model, state, mesh):
    """``distribute2d`` for a ``LayeredModel`` and ``LayeredState`` (the layer axis
    replicated)."""
    return _distribute2d(model, state, mesh, _shard_layered)


def gather_state2d(dist_state, model_serial, mesh):
    """The serial-layout state of all blocks' states (each block's interior; the
    halos are 0 and refilled by the next serial step)."""
    return _gather_blocks(dist_state, model_serial.grid, model_serial.grid_ext,
                          *mesh.shape)


def gather_layered_state2d(dist_state, model_serial, mesh):
    """``gather_state2d`` for ``LayeredState``."""
    return gather_state2d(dist_state, model_serial, mesh)


def _step_fn2d(step, mesh, dist_model, nx_global, overlap, fold_mode):
    n_y, n_x = mesh.shape
    Spmd2D(0, 0, n_x, n_y, nx_global, mesh, fold_mode)  # refuses an unknown fold mode
    return ShardedStep(mesh, dist_model, functools.partial(step, overlap=overlap),
                       spmd_of=lambda k: Spmd2D(k % n_x, k // n_x, n_x, n_y, nx_global,
                                                mesh, fold_mode))


def sharded_step_fn2d(mesh, dist_model, nx_global: int, overlap=None,
                      fold_mode="auto") -> ShardedStep:
    """The 2-D sharded single-layer step of ``distribute2d``'s models:
    ``fn(dist_state, dt) -> dist_state``. ``overlap`` as in ``models/hydrostatic.py:
    step`` (the split in both directions); ``fold_mode`` as in ``ops/spmd2d.
    Spmd2D``."""
    return _step_fn2d(hydrostatic.step, mesh, dist_model, nx_global, overlap, fold_mode)


def sharded_layered_step_fn2d(mesh, dist_model, nx_global: int, overlap=None,
                              fold_mode="auto") -> ShardedStep:
    """The 2-D sharded layered step of ``distribute_layered2d``'s models."""
    return _step_fn2d(layered.layered_step, mesh, dist_model, nx_global, overlap,
                      fold_mode)
