"""Checkpoint and resume of the model state: npz files and checkpoint directories.

Counterpart: ``orthogonalsphericalshellgrids_tpu/utils/checkpoint.py``. As there, the
path decides the route:

- a path ending in ``.npz`` is one file. The leaves are written in the JAX package's
  flatten order, which is the dataclass field order of ``State`` and
  ``LayeredState`` (the same in both packages), under the same names ``leaf_0`` ...
  ``leaf_<n-1>``: a checkpoint written by either package loads into the other. A
  y-partitioned or 2-D run writes one file a rank, ``<stem>.rank<k>.npz``.
- any other path is a directory written and read through
  ``torch.distributed.checkpoint`` (DCP), the counterpart of the JAX package's orbax
  route: one data file for each writing process and DCP's ``.metadata``, each field
  under its name. The save is synchronous (it returns when the files are written, as
  orbax's ``wait_until_finished``) and atomic: DCP writes a sibling ``<path>.tmp``,
  renamed over ``path`` once DCP has finished, so a crash mid-write leaves no
  directory that ``Checkpointer.latest`` would pick; an existing directory of that
  name is replaced (orbax ``force=True``). The load fills new tensors of ``like``'s
  shapes, dtypes (a saved float64 field is cast, as orbax casts to the target) and
  devices.

  A sharded run writes one directory for all its ranks: rank k's blocks go under
  ``rank<k>/<field>``, ``t`` and ``iteration`` once (checked equal across the ranks),
  and the decomposition under ``layout/mesh`` ((n_y, n_x)) and ``layout/blocks``
  (each rank's first row, rows, first column, columns of the global interior). No
  rank gathers the state: the ranks of one process (``LocalExchange``) are written
  and read in one DCP call with ``no_dist=True``; one rank a process
  (``ProcessGroupExchange``) calls DCP with its own keys over the default process
  group. On load each rank reads its own keys onto its own device, after the saved
  decomposition is checked against the run's.

Orbax directories and DCP directories do not read each other (the port does not
import orbax): npz is the format that crosses between the packages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.layouts import REP, leaf_layout
from .output import rank_filename

__all__ = ["save_checkpoint", "load_checkpoint", "save_sharded_checkpoint",
           "load_sharded_checkpoint"]


def _is_npz(path) -> bool:
    return str(path).endswith(".npz")


# --------------------------------------------------------------------------------------
# npz files
# --------------------------------------------------------------------------------------

def _save_npz(path: str, state) -> None:
    leaves = [getattr(state, f.name) for f in dataclasses.fields(state)]
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{f"leaf_{i}": x.detach().cpu().numpy()
                        for i, x in enumerate(leaves)})
    os.replace(tmp, path)


def _load_npz(path: str, like):
    fields = dataclasses.fields(like)
    with np.load(path) as data:
        if len(data.files) != len(fields):
            raise ValueError(f"checkpoint {path!r} holds {len(data.files)} leaves, "
                             f"{type(like).__name__} has {len(fields)}")
        values = {f.name: torch.from_numpy(np.array(data[f"leaf_{i}"])).to(
            getattr(like, f.name).device) for i, f in enumerate(fields)}
    return type(like)(**values)


# --------------------------------------------------------------------------------------
# directories (torch.distributed.checkpoint)
# --------------------------------------------------------------------------------------

def _dcp():
    # imported here: the import takes seconds, and only directories need it
    import torch.distributed.checkpoint as dcp

    return dcp


@contextlib.contextmanager
def _no_dist_warning():
    """DCP warns on every ``no_dist=True`` call that it assumes one process; that is
    the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _agree(collective: bool, error) -> None:
    """Raise ``error`` (an exception or a message, None for none) on every rank if
    any rank of the default group has one (only this process's without a group), so
    that no rank goes on into a collective its peers have left."""
    if collective:
        errors = [None] * dist.get_world_size()
        dist.all_gather_object(errors, error)
        error = next((e for e in errors if e is not None), None)
    if isinstance(error, BaseException):
        raise error
    if error is not None:
        raise ValueError(error)


def _on_lead(collective: bool, fn) -> None:
    """``fn()`` on rank 0 (here, without a group); its failure raised on every
    rank."""
    error = None
    if not collective or dist.get_rank() == 0:
        try:
            fn()
        except OSError as e:
            error = e
    _agree(collective, error)


def _fresh_dir(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)  # left by a crash mid-write
    os.makedirs(path)


def _replace_dir(tmp: str, path: str) -> None:
    """``tmp`` renamed to ``path``; an existing ``path`` is moved aside first and
    removed after (``os.replace`` cannot replace a directory that holds files)."""
    if not os.path.lexists(path):
        os.replace(tmp, path)
        return
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    os.replace(path, old)
    os.replace(tmp, path)
    if os.path.isdir(old):
        shutil.rmtree(old)
    else:
        os.remove(old)


def _write_dir(path: str, tensors: dict, collective: bool) -> None:
    """DCP save of ``tensors`` ({key: tensor}) into the directory ``path``, through
    ``path + ".tmp"``; with ``collective`` every rank of the default group calls this
    with its own keys (a key given by several ranks is written once)."""
    dcp = _dcp()
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    _on_lead(collective, lambda: _fresh_dir(tmp))
    with _no_dist_warning():
        dcp.save(tensors, storage_writer=dcp.FileSystemWriter(tmp), no_dist=not collective)
    _on_lead(collective, lambda: _replace_dir(tmp, path))


def _saved(path: str) -> dict:
    """{key: DCP's storage metadata (``size``, ``properties.dtype``)} of the
    checkpoint directory ``path``."""
    dcp = _dcp()
    if not os.path.isfile(os.path.join(path, ".metadata")):
        raise FileNotFoundError(f"no complete checkpoint directory at {path!r} (no "
                                ".metadata)")
    return dcp.FileSystemReader(path).read_metadata().state_dict_metadata


def _shape_error(path: str, saved: dict, tensors: dict):
    """The message for the first key of ``tensors`` that ``saved`` lacks or holds in
    another shape, or None."""
    for key, x in tensors.items():
        if key not in saved:
            return f"checkpoint {path!r} holds no {key!r}"
        if tuple(saved[key].size) != tuple(x.shape):
            return (f"{key}: shape {tuple(x.shape)} is not compatible with the stored "
                    f"shape {tuple(saved[key].size)} in {path!r}")
    return None


def _read_dir(path: str, tensors: dict, collective: bool) -> None:
    """DCP load of the checkpoint directory ``path`` into ``tensors`` ({key:
    tensor}, filled in place, cast to their dtypes); with ``collective`` every rank
    of the default group calls this with its own keys."""
    dcp = _dcp()
    with _no_dist_warning():
        dcp.load(tensors, storage_reader=dcp.FileSystemReader(path), no_dist=not collective)


def _empty(x):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


def save_checkpoint(path: str, state) -> None:
    """Write the state to ``path``: a ``.npz`` file (both packages read it) or else a
    directory through DCP. Either is atomic (a ``.tmp`` sibling renamed over
    ``path``, an existing directory replaced) and complete when this returns; the
    npz route copies every tensor to the host first."""
    if _is_npz(path):
        _save_npz(path, state)
        return
    _write_dir(path, {f.name: getattr(state, f.name) for f in dataclasses.fields(state)},
               collective=False)


def load_checkpoint(path: str, like):
    """Load a state written by ``save_checkpoint``: an npz file (of either package;
    ``like`` gives the class and the device, each tensor keeps its saved dtype) or a
    DCP directory (new tensors of ``like``'s class, shapes, dtypes and devices; a
    field whose shape differs raises ``ValueError`` naming it)."""
    if _is_npz(path):
        return _load_npz(path, like)
    path = os.path.abspath(path)
    out = {f.name: _empty(getattr(like, f.name)) for f in dataclasses.fields(like)}
    saved = _saved(path)
    if set(saved) != set(out):
        raise ValueError(f"checkpoint {path!r} holds {sorted(saved)}, "
                         f"{type(like).__name__} has {sorted(out)}")
    error = _shape_error(path, saved, out)
    if error:
        raise ValueError(error)
    _read_dir(path, out, collective=False)
    return type(like)(**out)


# --------------------------------------------------------------------------------------
# sharded runs
# --------------------------------------------------------------------------------------

def _collective(dist_model) -> bool:
    """Whether this process holds one rank of a default process group of as many
    ranks as the run has (``ProcessGroupExchange``: every rank calls DCP over the
    group), not every rank of the run (``LocalExchange``: one DCP call here). With
    one rank both give the same directory."""
    n = dist_model[0].shard[1]
    if len(dist_model) == 1 and dist.is_initialized() and dist.get_world_size() == n:
        return True
    if len(dist_model) != n:
        raise ValueError(f"{len(dist_model)} of {n} ranks here: the ranks of one "
                         "process checkpoint together, and a rank of a process group "
                         "alone in its process, in a default group of the run's size")
    return False


def _layout(model) -> dict:
    """The decomposition of ``model``'s run: the mesh (n_y, n_x) and each rank's
    block of the global interior (first row, rows, first column, columns), from the
    rank's block size (every block of a mesh has the same)."""
    n_y, n_x = model.mesh_shape
    ny, nx = model.grid.Ny, model.grid.Nx
    blocks = [(k // n_x * ny, ny, k % n_x * nx, nx) for k in range(n_y * n_x)]
    return {"layout/mesh": torch.tensor([n_y, n_x], dtype=torch.int64),
            "layout/blocks": torch.tensor(blocks, dtype=torch.int64)}


def _describe(layout: dict) -> str:
    (n_y, n_x), blocks = layout["layout/mesh"].tolist(), layout["layout/blocks"]
    ny, nx = blocks[0, 1].item(), blocks[0, 3].item()
    return (f"{len(blocks)} ranks on an n_y x n_x = {n_y} x {n_x} mesh of {ny} x {nx} "
            f"blocks")


def _replicated(dist_state, collective: bool):
    """{name: tensor} of the fields that are the same on every rank (``t``,
    ``iteration``), this process's first rank's, after checking them bitwise equal
    across the ranks (a message for the first that differs, else None)."""
    names = [f.name for f in dataclasses.fields(dist_state[0])
             if leaf_layout(f.name) == REP]

    def key(state):
        return tuple(getattr(state, n).detach().cpu().numpy().tobytes() for n in names)

    mine = [key(s) for s in dist_state]
    if collective:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine[0])
        mine = every
    bad = next((k for k, x in enumerate(mine) if x != mine[0]), None)
    error = None if bad is None else (f"{', '.join(names)} differ between rank 0 and "
                                      f"rank {bad}")
    return {n: getattr(dist_state[0], n) for n in names}, error


def save_sharded_checkpoint(path: str, dist_state, dist_model) -> None:
    """Write the states of the ranks of a sharded run (``parallel``'s ``distribute*``
    models and their states, those this process holds).

    ``.npz``: one file a rank, ``<stem>.rank<k>.npz`` (``save_checkpoint``). Else one
    directory for all ranks through DCP, without gathering the state: rank k's fields
    under ``rank<k>/<field>``, ``t`` and ``iteration`` once (``ValueError`` where they
    differ between ranks), and the decomposition. With ``ProcessGroupExchange`` (one
    rank a process of the default group) every rank calls this with its own state;
    with ``LocalExchange`` one DCP call writes the ranks of this process."""
    if _is_npz(path):
        for state, model in zip(dist_state, dist_model):
            save_checkpoint(rank_filename(path, model.shard[0]), state)
        return
    collective = _collective(dist_model)
    tensors, error = _replicated(dist_state, collective)
    _agree(collective, error)
    for state, model in zip(dist_state, dist_model):
        tensors.update({f"rank{model.shard[0]}/{f.name}": getattr(state, f.name)
                        for f in dataclasses.fields(state) if leaf_layout(f.name) != REP})
    tensors.update(_layout(dist_model[0]))
    _write_dir(path, tensors, collective)


def load_sharded_checkpoint(path: str, like, dist_model):
    """The ranks' states written by ``save_sharded_checkpoint``, one for each model
    of ``dist_model``; ``like`` is a list of states of the same class, shapes, dtypes
    and devices (the ranks of this process, as in ``save_sharded_checkpoint``).

    ``.npz``: each from its rank's file. A directory: each rank reads only its own
    blocks (and ``t``, ``iteration``) into new tensors on its own device;
    ``ValueError`` naming both where the saved decomposition is not the run's, or a
    field's shape differs."""
    if _is_npz(path):
        return [load_checkpoint(rank_filename(path, model.shard[0]), s)
                for s, model in zip(like, dist_model)]
    collective = _collective(dist_model)
    path = os.path.abspath(path)
    want = _layout(dist_model[0])
    try:
        saved = _saved(path)
        layout = {k: torch.empty(tuple(saved[k].size), dtype=torch.int64)
                  for k in want if k in saved}
        error = (None if len(layout) == len(want) else
                 f"checkpoint {path!r} holds no decomposition (layout/mesh, layout/blocks)")
    except OSError as e:
        saved, error = {}, e
    _agree(collective, error)
    _read_dir(path, layout, collective=False)  # a few integers, read by every rank
    if not all(torch.equal(layout[k], want[k]) for k in want):
        error = (f"checkpoint {path!r} holds {_describe(layout)}; the run has "
                 f"{_describe(want)}")
    fields = [f.name for f in dataclasses.fields(like[0])]
    rep = [n for n in fields if leaf_layout(n) == REP]
    out = [{n: _empty(getattr(s, n)) for n in fields} for s in like]
    tensors = {n: out[0][n] for n in rep}
    for o, model in zip(out, dist_model):
        tensors.update({f"rank{model.shard[0]}/{n}": o[n] for n in fields if n not in rep})
    _agree(collective, error or _shape_error(path, saved, tensors))
    _read_dir(path, tensors, collective)
    for o in out[1:]:
        o.update({n: out[0][n].to(o[n].device, copy=True) for n in rep})
    return [type(s)(**o) for s, o in zip(like, out)]
