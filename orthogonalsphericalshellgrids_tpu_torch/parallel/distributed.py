"""Y-partitioned (1-D) distributed runs of both models.

Counterpart: ``orthogonalsphericalshellgrids_tpu/parallel/distributed.py``
(``make_mesh``, ``distribute``, ``gather_state``, ``sharded_step_fn``,
``distribute_layered``, ``gather_layered_state``, ``sharded_layered_step_fn``). The
reference supports exactly a 1-D y-partition: it builds the global grid on the host,
gives each rank a halo-inclusive range of rows (``src/distributed_tripolar_grid.jl:
47-49``), folds only on the last rank (``:143-147``) and exchanges halos between the
others (``:171``). Here:

- each shard is a model of its own: rows ``[k·ny, k·ny + ny + 2·Hy)`` of every base-
  or extended-halo tensor of the serial model (``parallel/layouts.py``), with the
  local ``Ny = ny``, built by the models' constructors, which rebuild the kernels'
  packs from the sliced planes; ``shard = (rank, n_shards)`` and ``mesh_shape =
  (n_y, n_x)`` mark it;
- the step on a shard is the serial step with its two fills exchanged
  (``ops/spmd.py``), so it runs the port's kernels on the rank's block, and its
  tendencies split by default where that is exact (``overlap``: the bulk pass on
  the rank's own rows, launched before the exchange, then two strips of boundary
  rows; ``models/hydrostatic.py:split_tendencies``); the strip models are built
  with the shards; the barotropic subcycle needs no exchange inside its loop, since
  the free-surface fields carry the widened halo on every rank;
- two exchanges (a "mesh"), each one object with one call: ``LocalExchange`` steps
  the n shards of one process in n threads in lockstep (on one card, where NCCL
  refuses two ranks on one GPU, or on the CPU), one thread at a time, a rank
  reading its neighbours' send buffers in place; ``ProcessGroupExchange`` runs one shard in each process of a
  ``torch.distributed`` group (NCCL on GPUs, gloo on the CPU) with
  ``batch_isend_irecv`` to the y neighbours (on NCCL its wait is documented as a
  stream wait, see the class);
- ``spawn`` starts the processes of a group with a ``file://`` rendezvous in a
  temporary directory;
- an ensemble (``models/ensemble.py:stack_members``) is distributed, stepped and
  gathered as one state, the counterpart of ``jax.vmap`` of the sharded step: its
  member axis leads every field of every rank, ``t`` and ``iteration`` are (B,) on
  each, and the fills, packs and exchanges carry the members as planes.

Both exchanges also carry the 2-D (x, y) mesh of ``parallel/distributed2d.py``
(``shape`` = (n_y, n_x), ranks iy·n_x + ix): ``rows2d`` exchanges a block's rows
with its y neighbours and its fold strip with the top blocks whose folds read it,
``cols2d`` its columns around the periodic x ring.

Geometries the JAX package refuses are refused: ``Ny % n`` and ``ny`` below the
extended halo (the barotropic subcycle folds that far).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import multiprocessing
import os
import queue
import shutil
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from .. import kernels
from ..grids.immersed import FIELDS as IB_FIELDS
from ..grids.immersed import ImmersedBoundary
from ..grids.tripolar import ARRAY_FIELDS, META_FIELDS, TripolarGrid
from ..kernels import tracer_adv
from ..models import hydrostatic, layered
from ..ops.spmd import Spmd
from ..ops.spmd2d import Spmd2D
from .layouts import BASE, EXT, REP, check_module, leaf_layout

__all__ = ["Spmd", "LocalExchange", "ProcessGroupExchange", "ShardedStep", "spawn",
           "make_mesh", "distribute", "gather_state", "sharded_step_fn",
           "distribute_layered", "gather_layered_state", "sharded_layered_step_fn",
           "run_steps"]


# --------------------------------------------------------------------------------------
# Exchanges
# --------------------------------------------------------------------------------------

class LocalExchange:
    """The exchange of ``n_shards`` shards stepped in one process, one thread a shard
    (``ShardedStep``), which run one at a time in rank order: a thread works only
    inside ``turn(rank)``, and at each exchange it leaves its send buffer in a slot
    and hands the turn to the next rank; when the turn comes back every rank has
    left its buffer, and it takes one part of each neighbour's buffer as it is (the
    rows are read in place, no copy). Slots alternate between two sets, so a rank's
    next buffer never replaces one a neighbour has still to read. One thread at a
    time keeps the threads from contending for the interpreter lock at every kernel
    launch. On a card every thread launches on the caller's stream, so a neighbour's
    packed rows are written before the fill that reads them; a thread holds the
    neighbours' buffers until its fill is enqueued, so the allocator cannot reuse
    them early."""

    def __init__(self, n_shards: int, timeout: float = 600.0, shape=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        # (n_y, n_x) of a 2-D mesh (parallel/distributed2d.py), ranks iy*n_x + ix
        self.shape = (n_shards, 1) if shape is None else tuple(shape)
        if self.shape[0] * self.shape[1] != n_shards:
            raise ValueError(f"a mesh of shape {self.shape} holds {n_shards} shards?")
        self.ranks = tuple(range(n_shards))
        self.timeout = timeout
        # one lock; a condition a rank, so that handing on the turn wakes one thread
        self._lock = threading.Lock()
        self._conds = [threading.Condition(self._lock) for _ in self.ranks]
        self.reset()

    def reset(self):
        """Start afresh: rank 0's turn, no buffers (also after ``abort``)."""
        with self._lock:
            self._turn = 0
            self._broken = False
            self._slots = [[None] * self.n_shards, [None] * self.n_shards]
            self._made = [0] * self.n_shards
            for cond in self._conds:
                cond.notify_all()

    def _wait_turn(self, rank):
        if not self._conds[rank].wait_for(lambda: self._broken or self._turn == rank,
                                          self.timeout):
            self._broken = True
            for cond in self._conds:
                cond.notify_all()
            raise threading.BrokenBarrierError(f"rank {rank} waited {self.timeout} s")
        if self._broken:
            raise threading.BrokenBarrierError(f"rank {rank}: another shard failed")

    def _pass(self, rank):
        self._turn = (rank + 1) % self.n_shards
        self._conds[self._turn].notify()

    @contextlib.contextmanager
    def turn(self, rank):
        """Run the block as rank ``rank``'s turn: wait for it, and hand it on after."""
        with self._lock:
            self._wait_turn(rank)
        try:
            yield
        finally:
            with self._lock:
                self._pass(rank)

    def _swap(self, rank, send):
        """Leave ``send`` in the rank's slot, hand on the turn and wait for it to come
        back: then every rank has left its buffer, and the slots are returned (the
        rank holds the turn while it reads them)."""
        with self._lock:
            slots = self._slots[self._made[rank] % 2]
            self._made[rank] += 1
            slots[rank] = send
            self._pass(rank)
            self._wait_turn(rank)
        return slots

    def __call__(self, rank, send, part_len):
        slots = self._swap(rank, send)
        south = slots[rank - 1][:part_len] if rank > 0 else None
        north = slots[rank + 1][part_len:] if rank + 1 < self.n_shards else None
        return south, north

    def rows2d(self, spmd, send, part_len, fold_len, lows=False):
        """The y exchange of block ``spmd`` (an ``ops/spmd2d.Spmd2D``): its send
        buffer (``pack_strips``: the rows up, the rows down, its fold strip) for
        (the rows from below, the rows from above, the fold strips its fold reads,
        ``ops/spmd2d.fold_sources``, and with ``lows`` the send rows of the
        blocks below those, for a top block of Ny = Hy rows)."""
        slots = self._swap(spmd.rank, send)
        return _rows2d(spmd, lambda r: slots[r], part_len, fold_len, lows)

    def cols2d(self, spmd, send, col_len):
        """The x exchange of block ``spmd`` around the periodic ring: its columns
        (east-bound, then west-bound) for (the columns from the west, from the
        east)."""
        slots = self._swap(spmd.rank, send)
        n_x, ix, iy = spmd.n_x, spmd.ix, spmd.iy
        return (slots[spmd.rank_of((ix - 1) % n_x, iy)][:col_len],
                slots[spmd.rank_of((ix + 1) % n_x, iy)][col_len:])

    def abort(self):
        """Release the other shards' threads (they raise) after one shard failed."""
        with self._lock:
            self._broken = True
            for cond in self._conds:
                cond.notify_all()


def _rows2d(spmd, buffer_of, part_len, fold_len, lows=False):
    """(south rows, north rows, fold strips, rows below the strips) of block
    ``spmd`` from the send buffers ``buffer_of(rank)`` of its neighbours, of the top
    blocks its fold reads and, with ``lows``, of the blocks below those."""
    ix, iy = spmd.ix, spmd.iy
    south = buffer_of(spmd.rank_of(ix, iy - 1))[:part_len] if iy > 0 else None
    north = (buffer_of(spmd.rank_of(ix, iy + 1))[part_len:2 * part_len]
             if iy + 1 < spmd.n_y else None)
    sources = spmd.fold_sources
    strips = below = None
    if sources:
        top = spmd.n_y - 1
        strips = [buffer_of(spmd.rank_of(q, top))[2 * part_len:2 * part_len + fold_len]
                  if q in sources else None for q in range(spmd.n_x)]
        if lows:
            below = [buffer_of(spmd.rank_of(q, top - 1))[:part_len]
                     if q in sources else None for q in range(spmd.n_x)]
    return south, north, strips, below


def _fold_destinations(spmd):
    """The x-ranks of the top blocks whose folds read block ``spmd``'s fold strip
    (``spmd`` a top block) or, for a top block of Ny = Hy rows, its top rows
    (``spmd`` a block of the row below the top)."""
    top = dataclasses.replace(spmd, iy=spmd.n_y - 1)
    return tuple(d for d in range(spmd.n_x)
                 if spmd.ix in dataclasses.replace(top, ix=d).fold_sources)


class ProcessGroupExchange:
    """The exchange of one rank of the default ``torch.distributed`` process group
    (one shard a process): ``batch_isend_irecv`` of the two parts of the send buffer
    to the ranks above and below, and of the received rows into a fresh buffer. On
    NCCL ``wait`` is documented to make the current stream wait for the transfer, not
    the host (that the host does not wait is not measured). With one rank the step
    takes the serial route and this call is never made; NCCL refuses two ranks on one
    card, so the exchange between ranks runs with a card a rank
    (``bench_scaling_torch.py --exchange nccl``: 2 and 4 H100s, every shard bitwise
    the serial run). A failed rank's peers see the backend's timeout."""

    def __init__(self, shape=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupExchange needs an initialized default "
                               "process group (torch.distributed.init_process_group)")
        self.n_shards = dist.get_world_size()
        # (n_y, n_x) of a 2-D mesh, ranks iy*n_x + ix
        self.shape = (self.n_shards, 1) if shape is None else tuple(shape)
        if self.shape[0] * self.shape[1] != self.n_shards:
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{self.shape[0] * self.shape[1]} ranks, the group has "
                             f"{self.n_shards}")
        self.ranks = (dist.get_rank(),)

    @staticmethod
    def _run(ops):
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    def rows2d(self, spmd, send, part_len, fold_len, lows=False):
        """``LocalExchange.rows2d`` across processes: the rows with the y
        neighbours, the fold strips among the top row of blocks (to and from each
        block whose fold reads the other's), and with ``lows`` the top rows of the
        row below the top to the top blocks whose folds read them, point to point
        (tagged by kind: a block below the top may send both its rows up and its
        rows to the same top block)."""
        recv = torch.empty(2 * part_len, dtype=send.dtype, device=send.device)
        ix, iy = spmd.ix, spmd.iy
        ops = []
        if iy + 1 < spmd.n_y:
            up = spmd.rank_of(ix, iy + 1)
            ops += [dist.P2POp(dist.isend, send[:part_len], up, tag=1),
                    dist.P2POp(dist.irecv, recv[part_len:], up, tag=2)]
        if iy > 0:
            down = spmd.rank_of(ix, iy - 1)
            ops += [dist.P2POp(dist.isend, send[part_len:2 * part_len], down, tag=2),
                    dist.P2POp(dist.irecv, recv[:part_len], down, tag=1)]
        own = send[2 * part_len:2 * part_len + fold_len]
        got, below = {ix: own}, {ix: recv[:part_len]}
        top = spmd.n_y - 1
        sources = spmd.fold_sources
        if iy == top:
            for d in _fold_destinations(spmd):
                if d != ix:
                    ops.append(dist.P2POp(dist.isend, own, spmd.rank_of(d, top), tag=3))
            for q in sources:
                if q != ix:
                    got[q] = torch.empty_like(own)
                    ops.append(dist.P2POp(dist.irecv, got[q], spmd.rank_of(q, top), tag=3))
                    if lows:
                        below[q] = torch.empty_like(recv[:part_len])
                        ops.append(dist.P2POp(dist.irecv, below[q],
                                              spmd.rank_of(q, top - 1), tag=4))
        elif lows and iy == top - 1:
            for d in _fold_destinations(spmd):
                if d != ix:
                    ops.append(dist.P2POp(dist.isend, send[:part_len],
                                          spmd.rank_of(d, top), tag=4))
        self._run(ops)
        strips = lowrows = None
        if sources:
            strips = [got[q] if q in sources else None for q in range(spmd.n_x)]
            if lows:
                lowrows = [below[q] if q in sources else None for q in range(spmd.n_x)]
        return (recv[:part_len] if iy > 0 else None,
                recv[part_len:] if iy + 1 < spmd.n_y else None, strips, lowrows)

    def cols2d(self, spmd, send, col_len):
        """``LocalExchange.cols2d`` across processes, tagged by direction (with two
        x-ranks both neighbours are one process)."""
        recv = torch.empty_like(send)
        n_x, ix, iy = spmd.n_x, spmd.ix, spmd.iy
        east, west = spmd.rank_of((ix + 1) % n_x, iy), spmd.rank_of((ix - 1) % n_x, iy)
        self._run([dist.P2POp(dist.isend, send[:col_len], east, tag=1),
                   dist.P2POp(dist.irecv, recv[:col_len], west, tag=1),
                   dist.P2POp(dist.isend, send[col_len:], west, tag=2),
                   dist.P2POp(dist.irecv, recv[col_len:], east, tag=2)])
        return recv[:col_len], recv[col_len:]

    def __call__(self, rank, send, part_len):
        recv = torch.empty_like(send)
        ops = []
        if rank + 1 < self.n_shards:
            ops += [dist.P2POp(dist.isend, send[:part_len], rank + 1),
                    dist.P2POp(dist.irecv, recv[part_len:], rank + 1)]
        if rank > 0:
            ops += [dist.P2POp(dist.isend, send[part_len:], rank - 1),
                    dist.P2POp(dist.irecv, recv[:part_len], rank - 1)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return (recv[:part_len] if rank > 0 else None,
                recv[part_len:] if rank + 1 < self.n_shards else None)

    def turn(self, rank):
        return contextlib.nullcontext()

    def abort(self):
        pass

    def reset(self):
        pass


def make_mesh(n_shards: int) -> LocalExchange:
    """The mesh of ``n_shards`` shards stepped in this process (``LocalExchange``);
    a rank of a process group uses ``ProcessGroupExchange()``."""
    return LocalExchange(n_shards)


def _rank_main(rank, n, fn, backend, init_file, timeout, args, results):
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:  # CPU ranks of one host share its cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        dist.init_process_group(backend, init_method="file://" + init_file, rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, out, None))
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, None, traceback.format_exc()))


def spawn(n, fn, backend="gloo", init_file=None, args=(), timeout=600.0):
    """Run ``fn(rank, n, *args)`` in ``n`` new processes joined in the default
    process group of ``backend`` (``"gloo"`` on the CPU, ``"nccl"`` with one card a
    rank), rendezvous through ``init_file`` (by default a file in a new temporary
    directory, removed afterwards). ``fn`` and ``args`` are pickled; ``fn`` must be
    importable. Returns the ranks' return values in rank order; raises with the
    failing ranks' tracebacks, and stops every process it started."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="osg_rendezvous_")
        init_file = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, name=f"osg-rank-{rank}",
                         args=(rank, n, fn, backend, init_file, timeout, args, results))
             for rank in range(n)]
    got, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < n and not errors:
            try:
                rank, out, err = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.name for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"{', '.join(dead)} died without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"no result from every rank within {timeout} s")
                continue
            got[rank] = out
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
    finally:
        for p in procs:
            if p.pid is None:  # not started: a start before it raised
                continue
            if errors and p.is_alive():
                p.kill()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("spawned ranks failed:\n" + "\n".join(errors))
    return [got[rank] for rank in range(n)]


# --------------------------------------------------------------------------------------
# Serial <-> sharded layouts
# --------------------------------------------------------------------------------------

def _shape(model):
    """(ny, base Hy, extended Hy) of an n-way partition, checked as the JAX package
    checks it (``parallel/distributed.py:122-130``)."""
    g, ge = model.grid, model.grid_ext

    def check(n):
        if g.Ny % n != 0:
            raise ValueError(f"Ny={g.Ny} must be divisible by the number of shards {n}")
        ny = g.Ny // n
        if ny < ge.Hy:
            raise ValueError(
                f"local rows ny={ny} must cover the extended halo Hy={ge.Hy} (the "
                "exchange-free barotropic subcycle folds that far)")
        return ny

    return check


class _Block:
    """Block (``ky``, ``kx``)'s rows and columns of the tensors of one model or
    state, by layout: rows ``[ky·ny, ky·ny + ny + 2·Hy)`` and columns ``[kx·nx,
    kx·nx + nx + 2·Hx)`` (all columns where ``nx`` is None, a y-partition), with
    ``hy``/``hx`` the halos of each layout."""

    def __init__(self, ky, kx, ny, nx, hy, hx):
        self.ky, self.kx, self.ny, self.nx, self.hy, self.hx = ky, kx, ny, nx, hy, hx

    def __call__(self, name, a):
        tag = leaf_layout(name)
        if tag == REP or a is None:
            return None if a is None else a.clone()
        r0, Hy = self.ky * self.ny, self.hy[tag]
        if self.nx is None:
            return a[..., r0:r0 + self.ny + 2 * Hy, :].clone()
        c0, Hx = self.kx * self.nx, self.hx[tag]
        return a[..., r0:r0 + self.ny + 2 * Hy, c0:c0 + self.nx + 2 * Hx].clone()


def _shard_grid(grid, prefix, block):
    meta = dict({n: getattr(grid, n) for n in META_FIELDS}, Ny=block.ny)
    if block.nx is not None:
        meta["Nx"] = block.nx
    return TripolarGrid({n: block(f"{prefix}.{n}", getattr(grid, n)) for n in ARRAY_FIELDS},
                        meta)


def _shard_hydrostatic(model, rows):
    """The single-layer model of ``rows``' rank, built by its constructor from the
    rank's rows of the grids, the immersed boundary, ``DERIVED`` and the closure
    planes."""
    n_static = len(tracer_adv.STATIC_PLANES)
    adv = rows("adv_pack", model.adv_pack)
    return hydrostatic.HydrostaticModel(
        _shard_grid(model.grid, "grid", rows), _shard_grid(model.grid_ext, "grid_ext", rows),
        ImmersedBoundary({n: rows(f"ib.{n}", getattr(model.ib, n)) for n in IB_FIELDS}),
        {n: rows(n, getattr(model, n)) for n in hydrostatic.DERIVED},
        substeps=model.substeps, fractional_dt=model.fractional_dt, g=model.g,
        coriolis=model.coriolis, options={n: getattr(model, n) for n in hydrostatic.OPTIONS},
        mom_lay=rows("mom_lay", model.mom_lay),
        kappa=list(adv[n_static:]) if adv.shape[0] > n_static else None)


def _shard_layered(model, rows):
    arrays = {n: rows(n, getattr(model, n)) for n in (*layered.BUFFERS, "mom_lay", "n_wet")}
    return layered.LayeredModel(_shard_hydrostatic(model.baro, rows), arrays,
                                {n: getattr(model, n) for n in layered.META})


def _shard_state(state, rows):
    return type(state)(**{f.name: rows(f.name, getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def _blocks(model, state, mesh, shard_model, ny, nx, n_x):
    """The models and states of the blocks this process holds (``mesh.ranks``, rank
    ``ky·n_x + kx``), each built by ``shard_model``, with the strip models of the
    overlap split where it is exact."""
    n = mesh.n_shards
    check_module(model)
    g, ge = model.grid, model.grid_ext
    hy, hx = {BASE: g.Hy, EXT: ge.Hy}, {BASE: g.Hx, EXT: ge.Hx}
    baro = model.baro if isinstance(model, layered.LayeredModel) else model
    models, states = [], []
    for k in mesh.ranks:
        block = _Block(k // n_x, k % n_x, ny, nx, hy, hx)
        m = shard_model(model, block)
        m.shard, m.mesh_shape = (k, n), (n // n_x, n_x)
        if n > 1 and hydrostatic.overlap_supported(baro, m.grid):
            hydrostatic.strip_views(m, two_d=nx is not None)
        models.append(m)
        states.append(_shard_state(state, block))
    return models, states


def _distribute(model, state, mesh, shard_model):
    return _blocks(model, state, mesh, shard_model, _shape(model)(mesh.n_shards), None, 1)


def distribute(model, state, mesh):
    """The shards of a serial single-layer ``model`` and ``state`` that this process
    holds (``mesh.ranks``): (list of models, list of states), on the serial model's
    device. Requires ``Ny % n == 0`` and ``ny`` at least the extended halo."""
    return _distribute(model, state, mesh, _shard_hydrostatic)


def distribute_layered(model, state, mesh):
    """``distribute`` for a ``LayeredModel`` and ``LayeredState`` (the layer axis
    replicated, rows partitioned)."""
    return _distribute(model, state, mesh, _shard_layered)


def _gather_blocks(dist_state, grid, grid_ext, n_y, n_x=1):
    """The serial-layout state of the states of all blocks of an (``n_x``, ``n_y``)
    mesh, in rank order (each block's interior; the halos are 0)."""
    if len(dist_state) != n_y * n_x:
        raise ValueError(f"gather needs all {n_y * n_x} shards, got {len(dist_state)}")
    ny, nx = grid.Ny // n_y, grid.Nx // n_x
    hy, hx = {BASE: grid.Hy, EXT: grid_ext.Hy}, {BASE: grid.Hx, EXT: grid_ext.Hx}

    def join(name):
        parts = [getattr(s, name) for s in dist_state]
        tag = leaf_layout(name)
        if tag == REP:
            return parts[0].clone()
        Hy, Hx = hy[tag], hx[tag]
        out = parts[0].new_zeros(parts[0].shape[:-2] + (grid.Ny + 2 * Hy,
                                                        grid.Nx + 2 * Hx))
        for k, p in enumerate(parts):
            ky, kx = divmod(k, n_x)
            out[..., Hy + ky * ny:Hy + (ky + 1) * ny, Hx + kx * nx:Hx + (kx + 1) * nx] = \
                p[..., Hy:Hy + ny, Hx:Hx + nx]
        return out

    return type(dist_state[0])(**{f.name: join(f.name)
                                  for f in dataclasses.fields(dist_state[0])})


def gather_state(dist_state, model_serial, n):
    """The serial-layout ``State`` of the ``n`` shards' states (each rank's interior
    rows; the halos are 0 and refilled by the next serial step)."""
    return _gather_blocks(dist_state, model_serial.grid, model_serial.grid_ext, n)


def gather_layered_state(dist_state, model_serial, n):
    """``gather_state`` for ``LayeredState``."""
    return _gather_blocks(dist_state, model_serial.grid, model_serial.grid_ext, n)


# --------------------------------------------------------------------------------------
# The sharded steps
# --------------------------------------------------------------------------------------

class ShardedStep:
    """``fn(dist_state, dt) -> dist_state``: one step of every shard this process
    holds, through ``step_fn(model, state, dt, spmd=spmd_of(rank))`` (by default
    the rank's ``Spmd`` of a y-partition). With several shards (``LocalExchange``)
    each steps in its own thread, on the caller's CUDA stream; ``launches[i]``
    counts the kernels shard i launched (``kernels.counting``)."""

    def __init__(self, mesh, dist_model, step_fn, spmd_of=None):
        self.mesh = mesh
        self.spmd_of = spmd_of or (lambda rank: Spmd(rank, mesh.n_shards, mesh))
        self.models = list(dist_model)
        if len(self.models) != len(mesh.ranks):
            raise ValueError(f"the mesh holds {len(mesh.ranks)} shards here, got "
                             f"{len(self.models)} models")
        self._step = step_fn
        self.launches = [dict.fromkeys(kernels.LAUNCHES, 0) for _ in self.models]
        self._pool = ThreadPoolExecutor(len(self.models)) if len(self.models) > 1 else None

    def _one(self, i, state, dt, stream):
        rank = self.mesh.ranks[i]
        spmd = self.spmd_of(rank)
        try:
            with self.mesh.turn(rank), kernels.counting(self.launches[i]):
                if stream is None:
                    return self._step(self.models[i], state, dt, spmd=spmd)
                with torch.cuda.stream(stream):
                    return self._step(self.models[i], state, dt, spmd=spmd)
        except BaseException:
            self.mesh.abort()
            raise

    def __call__(self, dist_state, dt):
        if len(dist_state) != len(self.models):
            raise ValueError(f"{len(self.models)} shards, got {len(dist_state)} states")
        if self._pool is None:
            return [self._one(0, dist_state[0], dt, None)]
        dev = self.models[0].device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        futures = [self._pool.submit(self._one, i, s, dt, stream)
                   for i, s in enumerate(dist_state)]
        errors = [f.exception() for f in futures]
        if any(e is not None for e in errors):
            self.mesh.reset()
            # the first failure that is not another shard's broken barrier
            raise next((e for e in errors if e is not None and
                        not isinstance(e, threading.BrokenBarrierError)),
                       next(e for e in errors if e is not None))
        return [f.result() for f in futures]

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()


def sharded_step_fn(mesh, dist_model, overlap=None) -> ShardedStep:
    """The sharded single-layer step of ``distribute``'s models:
    ``fn(dist_state, dt) -> dist_state``. ``overlap`` as in ``models/hydrostatic.py:
    step`` (by default the split, where it is exact)."""
    return ShardedStep(mesh, dist_model, functools.partial(hydrostatic.step,
                                                           overlap=overlap))


def sharded_layered_step_fn(mesh, dist_model, overlap=None) -> ShardedStep:
    """The sharded layered step of ``distribute_layered``'s models (``overlap`` as
    in ``sharded_step_fn``)."""
    return ShardedStep(mesh, dist_model, functools.partial(layered.layered_step,
                                                           overlap=overlap))


def run_steps(rank, n, dist_model, dist_state, dt, n_steps, mesh2d=None):
    """One rank of a process group (``spawn``): step shard ``rank`` of
    ``dist_model``/``dist_state`` (the lists of all ``n`` shards, as ``distribute``
    made them) ``n_steps`` times at ``dt`` through ``ProcessGroupExchange``. With
    ``mesh2d`` = (n_x, n_y, nx_global, fold_mode) the shards are the blocks of
    ``parallel/distributed2d.py:distribute2d``. Returns the rank's state as {field:
    numpy array}."""
    model, state = dist_model[rank], dist_state[rank]
    step_fn = layered.layered_step if isinstance(model, layered.LayeredModel) else \
        hydrostatic.step
    if mesh2d is None:
        mesh = ProcessGroupExchange()
        fn = ShardedStep(mesh, [model], step_fn)
    else:
        n_x, n_y, nx_global, fold_mode = mesh2d
        mesh = ProcessGroupExchange(shape=(n_y, n_x))
        fn = ShardedStep(mesh, [model], step_fn, spmd_of=lambda k: Spmd2D(
            k % n_x, k // n_x, n_x, n_y, nx_global, mesh, fold_mode))
    states = [state]
    for _ in range(n_steps):
        states = fn(states, dt)
    return {f.name: getattr(states[0], f.name).cpu().numpy()
            for f in dataclasses.fields(states[0])}
