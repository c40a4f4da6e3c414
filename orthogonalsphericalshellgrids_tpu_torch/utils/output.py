"""Output writing and time-series reading.

Counterpart: ``orthogonalsphericalshellgrids_tpu/utils/output.py`` (``OutputWriter``,
``NetCDFWriter``, ``FieldTimeSeries``, ``read_netcdf_series``), in the same file
formats, so that either package reads the other's output:

- ``OutputWriter``: a zip of ``.npy`` members, one per field and snapshot
  (``c.000004.npy``) plus ``times.000004.npy``, appended in O(snapshot) time; by
  default the compression and disk IO run on a writer thread while the steps go on
  (``async_write=False``: on the simulation thread).
- ``NetCDFWriter``: NetCDF3 (64-bit offset) through ``scipy.io.netcdf_file``;
- ``ShardedOutputWriter``: the y-partitioned runs' output, one archive a rank
  (``<stem>.rank<k>.npz``) holding that rank's interior rows; ``FieldTimeSeries``
  stitches the ranks' archives back into the global interior.

Every output is copied to the host on the simulation thread before ``__call__``
returns (``tensor.detach().cpu()``, a fresh copy also for CPU tensors): a later step
may write into the same storage, and only host copies reach the writer thread. That
copy is the one place a writer waits for the card (counted as ``wait.output.copy``
under a profiler; ``OutputWriter`` records its copies and its writes as the spans
``osg.output.copy`` and ``osg.output.write``, and a call that waits for its writer
thread as ``osg.output.handoff``, ``utils/profiling.py``). With
``with_halos=False`` a field
whose last two dims are the base or the widened grid's halo-inclusive shape is cropped
to its interior; a leading layer dim is kept.
"""

from __future__ import annotations

import os
import queue
import threading
import zipfile
from typing import Callable

import numpy as np
import torch

from .profiling import count, span

__all__ = ["OutputWriter", "NetCDFWriter", "ShardedOutputWriter", "FieldTimeSeries",
           "read_netcdf_series", "rank_filename"]


_SHARD_MEMBER = "shard.npy"  # (rank, number of ranks) of a ShardedOutputWriter archive


def rank_filename(filename: str, k: int) -> str:
    """The archive of rank ``k`` of a y-partitioned run: ``<stem>.rank<k><ext>``
    (``.npz`` without an extension)."""
    stem, ext = os.path.splitext(filename)
    return f"{stem}.rank{k}{ext or '.npz'}"


def _host(x) -> np.ndarray:
    """A host copy of ``x`` (tensor or array) that no later step can change."""
    if torch.is_tensor(x):
        count("wait.output.copy")
        t = x.detach()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()
    return np.array(x)


def _crop(sim, arr: np.ndarray, with_halos: bool) -> np.ndarray:
    if with_halos:
        return arr
    for g in (sim.model.grid, sim.model.grid_ext):
        if arr.shape[-2:] == g.shape2d:
            return arr[..., g.interior2d[0], g.interior2d[1]]
    return arr


def _append_snapshot(filename: str, k: int, t: float, arrs: dict, compression) -> None:
    """Append one snapshot (all fields + the time stamp) to a zip-of-npy archive."""
    with zipfile.ZipFile(filename, "a", compression=compression) as z:
        for name, arr in arrs.items():
            with z.open(f"{name}.{k:06d}.npy", "w") as f:
                np.lib.format.write_array(f, np.ascontiguousarray(arr))
        with z.open(f"times.{k:06d}.npy", "w") as f:
            np.lib.format.write_array(f, np.asarray(t))


class OutputWriter:
    """Periodic field dumps: attach to a Simulation with a schedule.

    ``outputs`` maps name -> callable(sim) -> tensor or array. ``with_halos=False``
    crops to the interior of the base (or widened) grid.

    The fields are copied to the host when the callback fires. By default (unlike the
    JAX package's ``async_write=False``) the snapshot is then handed to a writer
    thread, which deflates and appends it while the next steps run: zlib releases
    the interpreter lock, so the simulation thread goes on launching. At most two
    snapshots are held on the host, one being written and one waiting: a call that
    finds the writer still busy with the previous snapshot waits for it (the span
    ``osg.output.handoff``). ``close()``, which the Simulation calls when its run
    ends or raises, writes what was handed over and stops the thread; the next
    snapshot starts it again. A write that fails on the thread is raised as a
    ``RuntimeError`` at the next call or at ``close()``, and no later snapshot is
    written. ``async_write=False`` writes on the simulation thread before the call
    returns, for a caller that reads the archive between callbacks.
    """

    def __init__(self, filename: str, outputs: dict[str, Callable], with_halos: bool = False,
                 overwrite_existing: bool = True, async_write: bool = True,
                 compress: bool = True):
        self.filename = filename
        self.outputs = outputs
        self.with_halos = with_halos
        self._async = async_write
        self._count = 0
        self._compression = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
        if overwrite_existing and os.path.exists(filename):
            os.remove(filename)
        elif os.path.exists(filename):
            # appending: continue numbering after the last snapshot present (duplicate
            # member names would make np.load keep one entry per name)
            with zipfile.ZipFile(filename) as z:
                idx = [int(n.split(".")[-2]) for n in z.namelist()
                       if n.startswith("times.") and n.endswith(".npy")]
            self._count = max(idx) + 1 if idx else 0
        self._error: BaseException | None = None  # the writer thread's first failure
        self._reported = False
        self._queue: queue.Queue = queue.Queue()
        self._idle = threading.Event()  # the thread holds no snapshot
        self._idle.set()
        self._thread: threading.Thread | None = None

    def __call__(self, sim) -> None:
        k = self._count
        with span("osg.output.copy", k):
            arrs = {name: _crop(sim, _host(fn(sim)), self.with_halos)
                    for name, fn in self.outputs.items()}
        if self._async and not self._idle.is_set():
            with span("osg.output.handoff", k):
                self._idle.wait()
        if self._error is not None:
            self._reported = True
            raise RuntimeError(f"OutputWriter for {self.filename!r} failed; snapshot "
                               f"{k} and later ones are not written") from self._error
        job = (k, float(sim.time), arrs)
        self._count += 1
        if not self._async:
            self._write(job)
            return
        if self._thread is None:
            self._thread = threading.Thread(target=self._drain, daemon=True,
                                            name=f"OutputWriter {self.filename}")
            self._thread.start()
        self._idle.clear()
        self._queue.put(job)

    def _write(self, job) -> None:
        k, t, arrs = job
        with span("osg.output.write", k):
            _append_snapshot(self.filename, k, t, arrs, self._compression)

    def _drain(self) -> None:
        while (job := self._queue.get()) is not None:
            try:
                self._write(job)
            except BaseException as e:  # noqa: BLE001 — raised on the simulation thread
                self._error = e
            finally:
                # set also after a failure, so that the next call or close() sees it
                self._idle.set()

    def close(self) -> None:
        """Write what was handed over and stop the writer thread (a no-op for a
        synchronous writer); raises a failed write that no call has raised yet."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None
        if self._error is not None and not self._reported:
            self._reported = True
            raise RuntimeError(
                f"OutputWriter for {self.filename!r} failed") from self._error


class ShardedOutputWriter:
    """Output of a y-partitioned run (``parallel/distributed.py``), one archive a rank
    as the reference writes one file a rank (``examples/distributed_bickley_jet.jl:
    83-87``): each snapshot appends every shard's interior rows to
    ``rank_filename(filename, k)``, in ``OutputWriter``'s format; the global array is
    never assembled. ``dist_model`` is the list of the shards this process holds
    (their ``shard`` gives the rank and the number of ranks, their grids the local
    sizes); each archive records its (rank, number of ranks), so that
    ``FieldTimeSeries(filename, name)`` stitches exactly one run's archives."""

    def __init__(self, filename: str, dist_model):
        self.filename = filename
        self.models = list(dist_model)
        self._count = 0
        for m in self.models:  # a new run replaces the ranks' archives
            with zipfile.ZipFile(self.rank_filename(m.shard[0]), "w") as z:
                with z.open(_SHARD_MEMBER, "w") as f:
                    np.lib.format.write_array(f, np.asarray(m.shard, dtype=np.int64))

    def rank_filename(self, k: int) -> str:
        return rank_filename(self.filename, k)

    def write(self, t: float, arrays: dict) -> None:
        """Append one snapshot: ``arrays`` maps a name to the list of the shards'
        tensors (in the order of ``dist_model``), each cropped to its rank's interior
        (base or extended halo alike: the interior is the centred ``ny`` rows and
        ``Nx`` columns)."""
        for i, m in enumerate(self.models):
            g = m.grid
            arrs = {}
            for name, parts in arrays.items():
                block = _host(parts[i])
                hy = (block.shape[-2] - g.Ny) // 2
                hx = (block.shape[-1] - g.Nx) // 2
                arrs[name] = block[..., hy:hy + g.Ny, hx:hx + g.Nx]
            _append_snapshot(self.rank_filename(m.shard[0]), self._count, t, arrs,
                             zipfile.ZIP_DEFLATED)
        self._count += 1

    def close(self) -> None:
        pass


class NetCDFWriter:
    """NetCDF output: one UNLIMITED ``time`` dimension, one record variable per
    output, and ``lam_cc``/``phi_cc`` coordinate variables for base-interior fields.
    Attach to a Simulation with a schedule, like OutputWriter."""

    def __init__(self, filename: str, outputs: dict[str, Callable],
                 with_halos: bool = False):
        self.filename = filename
        self.outputs = outputs
        self.with_halos = with_halos
        self._nc = None
        self._k = 0

    def _create(self, sim, arrs) -> None:
        from scipy.io import netcdf_file

        nc = netcdf_file(self.filename, "w", version=2)  # 64-bit offset
        nc.createDimension("time", None)
        tv = nc.createVariable("time", "d", ("time",))
        tv.units = b"seconds"

        def dim_for(hint, n):
            name = f"{hint}{n}"
            if name not in nc.dimensions:
                nc.createDimension(name, n)
            return name

        coords_dims = None
        g = sim.model.grid
        for name, a in arrs.items():
            hints = ["z", "y", "x"][-a.ndim:]
            dims = tuple(dim_for(h, s) for h, s in zip(hints, a.shape))
            nc.createVariable(name, "f" if a.dtype == np.float32 else "d",
                              ("time",) + dims)
            if a.shape[-2:] == (g.Ny, g.Nx):
                coords_dims = dims[-2:]
        if coords_dims is not None:
            for cname, coord in (("lam_cc", g.lam_cc), ("phi_cc", g.phi_cc)):
                cv = nc.createVariable(cname, "d", coords_dims)
                cv.units = b"degrees"
                cv[:] = g.interior(coord).detach().cpu().numpy().astype(np.float64)
        self._nc = nc

    def __call__(self, sim) -> None:
        arrs = {name: _crop(sim, _host(fn(sim)), self.with_halos)
                for name, fn in self.outputs.items()}
        if self._nc is None:
            self._create(sim, arrs)
        nc = self._nc
        nc.variables["time"][self._k] = float(sim.time)
        for name, a in arrs.items():
            nc.variables[name][self._k] = a
        self._k += 1
        nc.sync()

    def close(self) -> None:
        if self._nc is not None:
            self._nc.close()
            self._nc = None


def read_netcdf_series(filename: str, name: str):
    """(times, values) from a NetCDFWriter file, values shaped (time, ...)."""
    from scipy.io import netcdf_file

    with netcdf_file(filename, "r", mmap=False) as nc:
        return (np.array(nc.variables["time"][:]),
                np.array(nc.variables[name][:]))


def _shard_of(path: str, filename: str) -> tuple:
    """(rank, number of ranks) that a ``ShardedOutputWriter`` archive records."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{filename!r}: neither it nor its rank archive "
                                f"{path!r} exists")
    with zipfile.ZipFile(path) as z:
        if _SHARD_MEMBER not in z.namelist():
            raise ValueError(f"{path!r} records no rank ({_SHARD_MEMBER}): it is not a "
                             "ShardedOutputWriter archive")
        with z.open(_SHARD_MEMBER) as f:
            return tuple(int(v) for v in np.lib.format.read_array(f))


class FieldTimeSeries:
    """Reader for OutputWriter dumps (the reference's FieldTimeSeries):
    ``fts = FieldTimeSeries(path, "c")``; ``fts.times``, ``fts[i]``, ``len(fts)``,
    ``fts.data``, as numpy arrays.

    Also reads ``ShardedOutputWriter`` output: given the base filename (with no
    archive of its own), the interiors of ranks 0 .. n-1 are stitched along the row
    axis in rank order, n read from rank 0's archive. A missing rank, or an archive
    that another run left (of another number of ranks), raises; archives of ranks
    n and above are not read."""

    def __init__(self, filename: str, name: str):
        if not os.path.exists(filename):
            n = _shard_of(rank_filename(filename, 0), filename)[1]
            ranks = [rank_filename(filename, k) for k in range(n)]
            for k, f in enumerate(ranks):
                got = _shard_of(f, filename)
                if got != (k, n):
                    raise ValueError(f"{f!r} records rank {got[0]} of {got[1]}, not rank "
                                     f"{k} of the {n}-rank run of {filename!r}")
            parts = [FieldTimeSeries(f, name) for f in ranks]
            self.times = parts[0].times
            for p in parts[1:]:
                if not np.array_equal(p.times, self.times):
                    raise ValueError(f"the ranks' archives of {filename!r} hold other "
                                     "snapshot times")
            self._data = np.concatenate([p._data for p in parts], axis=-2)
            return
        with np.load(filename) as data:
            tkeys = sorted(k for k in data.files if k.startswith("times."))
            self.times = np.asarray([float(data[k]) for k in tkeys])
            fkeys = sorted(k for k in data.files if k.startswith(name + "."))
            if len(fkeys) != len(tkeys):
                raise KeyError(f"field {name!r} has {len(fkeys)} snapshots, "
                               f"expected {len(tkeys)}")
            self._data = np.stack([data[k] for k in fkeys]) if fkeys else np.zeros((0,))

    def __len__(self):
        return len(self.times)

    def __getitem__(self, i):
        return self._data[i]

    @property
    def data(self):
        return self._data
