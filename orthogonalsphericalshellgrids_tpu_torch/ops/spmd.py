"""The halo exchange of a y-partitioned run: the sharded counterpart of the fills.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/spmd.py`` (``Spmd``,
``fill_halos_spmd``, ``fill_halos_spmd_batch``, ``fill_halos_spmd_groups``). Each rank
holds rows ``[k·ny, k·ny + ny + 2·Hy)`` of every field, all columns (the reference's
y-partition, ``src/distributed_tripolar_grid.jl:30-31, 143-147, 171``); its grid's
``Ny`` is its own ``ny``. A fill on a rank:

- takes the send rows from the fields before anything is written: the top Hy
  interior rows for the rank above, the bottom Hy for the rank below
  (``ops/spmd.py:75-80`` of the JAX package);
- exchanges them with the neighbours (``Spmd.exchange``, ``parallel/distributed.py``);
- fills the south rows with the rows received from below, or zero-gradient on rank
  0; the north rows with the rows received from above, or the zipper fold on the
  last rank, where alone the fold rewrites half of the last interior row;
- wraps x last, so that the x-halo of every written row comes from its interior
  columns and never from the neighbour's halo (``:110``).

The steps fill their groups in place through ``fill_group`` and ``restore_group``:
with ``spmd`` None or one shard, exactly the serial group fill and restore
(``kernels/halo_fill.py``); otherwise one ``pack_strips`` launch, the exchange, and
one group fill in the rank's role. ``fill_halos_spmd``, ``fill_halos_spmd_batch`` and
``fill_halos_spmd_groups`` are the JAX package's names for the same route on copies:
each clones its fields and fills them through ``fill_group``, and returns new
tensors, as the JAX functions do. Every rank of a run must make the same sequence of
exchanges.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels import halo_fill

__all__ = ["Spmd", "fill_group", "restore_group", "fill_halos_spmd",
           "fill_halos_spmd_batch", "fill_halos_spmd_groups"]


@dataclasses.dataclass(frozen=True)
class Spmd:
    """One rank of a y-partitioned run: ``rank`` of ``n_shards``, and ``exchange``,
    called as ``exchange(rank, send, part_len)`` with the rank's send buffer (the rows
    for the rank above, then those for the rank below, ``part_len`` elements each);
    it returns the rows received from below and from above (one part of each
    neighbour's send buffer; None where the rank has no such neighbour)."""

    rank: int
    n_shards: int
    exchange: Any

    @property
    def role(self):
        return halo_fill.role_of(self.rank, self.n_shards)


def _serial(spmd):
    return spmd is None or spmd.n_shards == 1


def fill_group(fields, spmd=None, save=False):
    """``kernels/halo_fill.fill_halos_group(fields, save)`` on one rank of ``spmd``:
    the serial group fill without a partition or with one shard; else the send rows
    packed (one launch), exchanged, and the group filled in the rank's role with the
    received rows. Returns (the fields, the packed pre-fill strips or None)."""
    if _serial(spmd):
        return halo_fill.fill_halos_group(fields, save=save)
    fields = list(fields)
    role = spmd.role
    send = halo_fill.pack_strips(fields, role)
    south, north = spmd.exchange(spmd.rank, send, send.numel() // 2)
    return halo_fill.fill_halos_group(fields, save=save, role=role, south=south,
                                      north=north)


def restore_group(fields, saved, spmd=None):
    """``kernels/halo_fill.restore_strips_group`` in the role of the rank of ``spmd``
    (the serial restore without a partition or with one shard)."""
    if _serial(spmd):
        return halo_fill.restore_strips_group(fields, saved)
    return halo_fill.restore_strips_group(fields, saved, role=spmd.role)


def _fill_copy(tensors, locs, signs, Nx, ny, Hx, Hy, spmd):
    """Each of ``tensors`` copied and filled with its location and sign through
    ``fill_group``, at most ``MAX_FIELDS`` a group (an exchange a group). Returns the
    copies."""
    out = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
    fields = [(A, loc, sign, Nx, ny, Hx, Hy) for A, loc, sign in zip(out, locs, signs)]
    for i in range(0, len(fields), halo_fill.MAX_FIELDS):
        fill_group(fields[i:i + halo_fill.MAX_FIELDS], spmd)
    return out


def fill_halos_spmd(A, loc, sign, Nx, ny, Hx, Hy, spmd: Spmd):
    """Sharded halo fill of one field ``A`` (a halo-inclusive plane or stack of the
    rank's ``ny`` rows): one exchange, the rank's south rows, north rows or fold, and
    the x-wrap. Returns a new tensor."""
    return _fill_copy([A], [loc], [sign], Nx, ny, Hx, Hy, spmd)[0]


def fill_halos_spmd_batch(S, locs, signs, Nx, ny, Hx, Hy, spmd: Spmd):
    """Sharded halo fill of a ``(K, y, x)`` stack whose planes have their own
    location and sign (a group of single-plane fields). Returns a new tensor."""
    return torch.stack(_fill_copy(list(S), locs, signs, Nx, ny, Hx, Hy, spmd))


def fill_halos_spmd_groups(groups, locs, signs, Nx, ny, Hx, Hy, spmd: Spmd):
    """Sharded halo fill of several ``(K_i, y, x)`` stacks, each of one location and
    sign, with one exchange for up to ``MAX_FIELDS`` of them (the JAX package's
    strip-based group exchange). Returns the list of filled stacks, new tensors."""
    return _fill_copy(groups, locs, signs, Nx, ny, Hx, Hy, spmd)
