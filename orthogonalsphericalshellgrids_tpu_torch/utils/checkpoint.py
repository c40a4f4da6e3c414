"""Checkpoint and resume of the model state, as npz.

Counterpart: ``orthogonalsphericalshellgrids_tpu/utils/checkpoint.py`` (its npz path).
The leaves are written in the JAX package's flatten order, which is the dataclass
field order of ``State`` and ``LayeredState`` (the same in both packages), under the
same names ``leaf_0`` ... ``leaf_<n-1>``: a checkpoint written by either package loads
into the other. orbax has no counterpart here, so a path that does not end in
``.npz`` raises. A y-partitioned run (``parallel/distributed.py``) writes one
checkpoint a rank, ``<stem>.rank<k>.npz`` (``save_sharded_checkpoint``), and resumes
from them bitwise (``load_sharded_checkpoint``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .output import rank_filename

__all__ = ["save_checkpoint", "load_checkpoint", "save_sharded_checkpoint",
           "load_sharded_checkpoint"]


def _check_npz(path: str) -> None:
    if not str(path).endswith(".npz"):
        raise ValueError(f"checkpoint path {path!r}: the port writes npz checkpoints "
                         "only (a path ending in .npz); orbax directories are the JAX "
                         "package's")


def save_checkpoint(path: str, state) -> None:
    """Write the state's tensors to ``path`` (``.npz``), atomically: through
    ``path + ".tmp"`` and ``os.replace``, so that a crash mid-write leaves no
    truncated checkpoint that looks newest. Copies every tensor to the host."""
    _check_npz(path)
    leaves = [getattr(state, f.name) for f in dataclasses.fields(state)]
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{f"leaf_{i}": x.detach().cpu().numpy()
                        for i, x in enumerate(leaves)})
    os.replace(tmp, path)


def load_checkpoint(path: str, like):
    """Load a state written by ``save_checkpoint`` (of either package); ``like``
    supplies the class and the device. Each tensor keeps the dtype it was saved
    in."""
    _check_npz(path)
    fields = dataclasses.fields(like)
    with np.load(path) as data:
        if len(data.files) != len(fields):
            raise ValueError(f"checkpoint {path!r} holds {len(data.files)} leaves, "
                             f"{type(like).__name__} has {len(fields)}")
        values = {f.name: torch.from_numpy(np.array(data[f"leaf_{i}"])).to(
            getattr(like, f.name).device) for i, f in enumerate(fields)}
    return type(like)(**values)


def save_sharded_checkpoint(path: str, dist_state, dist_model) -> None:
    """Write each shard's state of a y-partitioned run to its rank's checkpoint,
    ``<stem>.rank<k>.npz`` (``save_checkpoint``); ``dist_model`` gives the ranks."""
    _check_npz(path)
    for state, model in zip(dist_state, dist_model):
        save_checkpoint(rank_filename(path, model.shard[0]), state)


def load_sharded_checkpoint(path: str, like, dist_model):
    """The shards' states written by ``save_sharded_checkpoint``: one for each model
    of ``dist_model``, from its rank's checkpoint; ``like`` is a list of states of
    the same class and devices."""
    _check_npz(path)
    return [load_checkpoint(rank_filename(path, model.shard[0]), s)
            for s, model in zip(like, dist_model)]
