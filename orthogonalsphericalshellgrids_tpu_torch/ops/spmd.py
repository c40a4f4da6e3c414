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
one group fill in the rank's role. A block of a 2-D (x, y) mesh (``ops/spmd2d.py``,
``Spmd2D``) fills through the same two names, in its own route. The overlap split
(``models/hydrostatic.py``) first wraps x locally (``wrap_group``, one launch that
saves what it writes), runs its bulk tendencies, and then fills the rest with the
same saved buffer, so that one restore gives the fields back.
``fill_halos_spmd``, ``fill_halos_spmd_batch`` and
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

__all__ = ["Spmd", "GroupFill", "fill_group", "restore_group", "wrap_group",
           "fill_halos_spmd", "fill_halos_spmd_batch", "fill_halos_spmd_groups"]


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

    def fill(self, fields, save=False, saved=None):
        """The group filled in this rank's role (``fill_group``)."""
        return fill_rows(fields, self.role, self.exchange, self.rank, save, saved)


def fill_rows(fields, role, exchange, rank, save=False, saved=None):
    """A y-partitioned rank's group fill: the send rows packed (one launch),
    exchanged (``exchange(rank, send, part_len)``), and the group filled in ``role``
    with the received rows; after ``wrap_group`` (its ``saved``) all but the wrapped
    cells. Returns (the fields, the packed pre-fill strips or None)."""
    fields = list(fields)
    send = halo_fill.pack_strips(fields, role)
    south, north = exchange(rank, send, send.numel() // 2)
    return halo_fill.fill_halos_group(
        fields, save=save, role=role, south=south, north=north,
        phase=halo_fill.ALL if saved is None else halo_fill.NO_WRAP, saved=saved)


def _serial(spmd):
    return spmd is None or spmd.n_shards == 1


def fill_group(fields, spmd=None, save=False, saved=None):
    """``kernels/halo_fill.fill_halos_group(fields, save)`` on one rank of ``spmd``:
    the serial group fill without a partition or with one shard; else the rank's
    route (``Spmd.fill``: pack, exchange and fill in its role; ``Spmd2D.fill``: the
    2-D route of ``ops/spmd2d.py``). ``saved`` is ``wrap_group``'s buffer: the fill
    then saves into it and leaves the wrapped cells alone. Returns (the fields, the
    packed pre-fill strips or None)."""
    if _serial(spmd):
        if saved is not None:
            raise ValueError("fill_group: a serial fill takes no wrapped buffer")
        return halo_fill.fill_halos_group(fields, save=save)
    return spmd.fill(fields, save=save, saved=saved)


def wrap_group(fields, spmd):
    """The local x-wrap of the rows between the south and north strips of every
    field, in place, on a rank of a y-partitioned run (one launch, ``WRAP``), the
    wrapped cells saved into a new packed buffer of the group's plan, which
    ``fill_group(..., saved=)`` then completes; None (and nothing written) off such
    a run, where no local wrap applies (serial, or an x-partitioned mesh)."""
    if _serial(spmd) or not isinstance(spmd, Spmd):
        return None
    return halo_fill.wrap_halos_group(fields, spmd.role)


def restore_group(fields, saved, spmd=None, phase=halo_fill.ALL):
    """``kernels/halo_fill.restore_strips_group`` in the role of the rank of ``spmd``
    (the serial restore without a partition or with one shard); with ``phase`` only
    the cells of that phase."""
    if _serial(spmd):
        return halo_fill.restore_strips_group(fields, saved, phase=phase)
    return halo_fill.restore_strips_group(fields, saved, role=spmd.role, phase=phase)


class GroupFill:
    """A step's in-place fill of its state's group, and its undoing. With ``wrap``
    (the overlap split's bulk pass reads a locally x-wrapped group) the wrap runs at
    once (``wrap_group``); ``fill`` fills the group (with the wrap's saved buffer);
    ``restore`` writes back exactly the cells written so far, so the group comes
    back bitwise also when the step fails between the two."""

    def __init__(self, fields, spmd=None, wrap=False):
        self.fields, self.spmd = list(fields), spmd
        self.saved = wrap_group(self.fields, spmd) if wrap else None
        self.phase = halo_fill.WRAP

    def fill(self):
        _, self.saved = fill_group(self.fields, self.spmd, save=True, saved=self.saved)
        self.phase = halo_fill.ALL

    def restore(self):
        if self.saved is not None:
            restore_group(self.fields, self.saved, self.spmd, phase=self.phase)


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
