"""Output writing and time-series reading.

Counterpart: ``orthogonalsphericalshellgrids_tpu/utils/output.py`` (``OutputWriter``,
``NetCDFWriter``, ``FieldTimeSeries``, ``read_netcdf_series``), in the same file
formats, so that either package reads the other's output:

- ``OutputWriter``: a zip of ``.npy`` members, one per field and snapshot
  (``c.000004.npy``) plus ``times.000004.npy``, appended in O(snapshot) time; with
  ``async_write=True`` the compression and disk IO run on a writer thread.
- ``NetCDFWriter``: NetCDF3 (64-bit offset) through ``scipy.io.netcdf_file``.

Every output is copied to the host on the simulation thread before ``__call__``
returns (``tensor.detach().cpu()``, a fresh copy also for CPU tensors): a later step
may write into the same storage, and only host copies reach the writer thread. That
copy is the one place a writer waits for the card. With ``with_halos=False`` a field
whose last two dims are the base or the widened grid's halo-inclusive shape is cropped
to its interior; a leading layer dim is kept.

``ShardedOutputWriter`` belongs to the distributed paths, which the port does not
have yet, and with it the per-rank stitching of ``FieldTimeSeries``.
"""

from __future__ import annotations

import os
import queue
import threading
import zipfile
from typing import Callable

import numpy as np
import torch

__all__ = ["OutputWriter", "NetCDFWriter", "FieldTimeSeries", "read_netcdf_series"]


def _host(x) -> np.ndarray:
    """A host copy of ``x`` (tensor or array) that no later step can change."""
    if torch.is_tensor(x):
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
    crops to the interior of the base (or widened) grid. ``async_write=True`` moves
    compression and disk IO to a writer thread (a queue of at most 4 snapshots);
    ``close()``, which the Simulation calls when its run ends, drains it.
    """

    def __init__(self, filename: str, outputs: dict[str, Callable], with_halos: bool = False,
                 overwrite_existing: bool = True, async_write: bool = False,
                 compress: bool = True):
        self.filename = filename
        self.outputs = outputs
        self.with_halos = with_halos
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
        self._error: BaseException | None = None
        self._queue: queue.Queue | None = None
        if async_write:
            self._queue = queue.Queue(maxsize=4)  # bounded: backpressure, not OOM
            threading.Thread(target=self._drain, daemon=True).start()

    def __call__(self, sim) -> None:
        arrs = {name: _crop(sim, _host(fn(sim)), self.with_halos)
                for name, fn in self.outputs.items()}
        self._raise_pending()
        job = (self._count, float(sim.time), arrs)
        self._count += 1
        if self._queue is not None:
            self._queue.put(job)
        else:
            self._write(job)

    def _write(self, job) -> None:
        k, t, arrs = job
        _append_snapshot(self.filename, k, t, arrs, self._compression)

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if self._error is None:  # after a failure, drop (don't corrupt) jobs
                    self._write(job)
            except BaseException as e:  # noqa: BLE001 — surfaced via _raise_pending
                if self._error is None:
                    self._error = e
            finally:
                # unconditionally, so that a failed write cannot deadlock close()
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async OutputWriter for {self.filename!r} failed") from err

    def close(self) -> None:
        """Drain the async writer (a no-op for a synchronous one); re-raises the
        first error the writer thread hit, if any."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()


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


class FieldTimeSeries:
    """Reader for OutputWriter dumps (the reference's FieldTimeSeries):
    ``fts = FieldTimeSeries(path, "c")``; ``fts.times``, ``fts[i]``, ``len(fts)``,
    ``fts.data``, as numpy arrays."""

    def __init__(self, filename: str, name: str):
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
