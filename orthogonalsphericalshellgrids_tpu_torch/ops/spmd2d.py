"""The halo exchange of a 2-D (x, y) decomposition, with the fold across x-ranks.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/spmd2d.py`` (``Spmd2D``,
``fill_halos_spmd2d_groups``, ``fill_halos_spmd2d_batch``). The reference supports
only a y-partition (``src/distributed_tripolar_grid.jl:30-31``): the zipper fold
pairs column i with column Nx - i + 1, so on an x-partition the top row of blocks
must see each other's columns. The fold reads only the top Hy + 1 interior rows, so
each top block sends that thin strip (at its interior columns) either to every
other top block (``"gather"``) or to the two blocks that need it (``"mirror"``: the
block's mirror rank r <-> n_x - 1 - r, and, for the one-column roll of face-x
planes, the rank whose mirror follows it); the two give the same bits.

Block (ix, iy) of an (n_x, n_y) mesh holds rows ``[iy·ny, iy·ny + ny + 2·Hy)`` and
columns ``[ix·nx, ix·nx + nx + 2·Hx)`` of every field, with the local ``Nx = nx``
and ``Ny = ny``. Its group fill runs in the JAX package's order:

1. the rows it sends in y and its fold strip are packed (one launch) and exchanged;
2. the fill's ``INNER`` phase (one launch) writes the interior columns of the south
   rows (received, or zero-gradient on y-rank 0) and of the north rows (received, or
   the fold from the strips on the top y-rank);
3. the x columns of all rows, now filled, are packed (one launch) and exchanged with
   the x-neighbours around the periodic ring;
4. the ``OUTER`` phase (one launch) writes every x-halo cell from them, so the
   corners and the x halos of the fold rows are the neighbours' filled rows.

Both fill phases save into one packed buffer in the serial plan's layout, so
``restore_group`` is one launch. With one x-rank the mesh is a y-partition and takes
that route (``ops/spmd.py``). ``fill_halos_spmd2d_groups`` and
``fill_halos_spmd2d_batch`` are the JAX package's names for the route on copies.
Every block of a run must make the same sequence of exchanges.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels import halo_fill
from .spmd import fill_group, fill_rows

__all__ = ["Spmd2D", "fold_sources", "fill_halos_spmd2d_groups", "fill_halos_spmd2d_batch"]


def fold_sources(role, fold_mode):
    """The x-ranks whose fold strips the fold of block ``role`` (a
    ``kernels/halo_fill.BlockRole``) reads: every one with the gather; its mirror
    rank and the one after it (whose first column is the face-x mirror of the
    block's first) with the mirror (``ops/spmd2d.py:_mirror_strips`` of the JAX
    package); none off the top row."""
    if not isinstance(role, halo_fill.BlockRole) or role.y not in (halo_fill.SINGLE,
                                                                   halo_fill.TOP):
        return ()
    if fold_mode == "gather":
        return tuple(range(role.n_x))
    m = role.n_x - 1 - role.ix
    return tuple(sorted({m, (m + 1) % role.n_x}))


@dataclasses.dataclass(frozen=True)
class Spmd2D:
    """Block (``ix``, ``iy``) of an (``n_x``, ``n_y``) mesh of ``nx_global``
    interior columns, and ``exchange``, the mesh's exchange (``parallel/
    distributed.py``: ``LocalExchange`` or ``ProcessGroupExchange``, over ranks
    numbered ``iy·n_x + ix``). ``fold_mode`` chooses how the fold crosses the
    x-partition: ``"gather"``, ``"mirror"`` or ``"auto"`` (gather for n_x <= 4,
    mirror beyond, as in the JAX package)."""

    ix: int
    iy: int
    n_x: int
    n_y: int
    nx_global: int
    exchange: Any
    fold_mode: str = "auto"

    def __post_init__(self):
        if not (0 <= self.ix < self.n_x and 0 <= self.iy < self.n_y):
            raise ValueError(f"block ({self.ix}, {self.iy}) is not one of an "
                             f"({self.n_x}, {self.n_y}) mesh")
        self.resolved_fold_mode  # noqa: B018 — refuses an unknown mode early

    @property
    def resolved_fold_mode(self) -> str:
        if self.fold_mode == "auto":
            return "gather" if self.n_x <= 4 else "mirror"
        if self.fold_mode not in ("gather", "mirror"):
            raise ValueError(f"unknown fold_mode {self.fold_mode!r}")
        return self.fold_mode

    @property
    def n_shards(self) -> int:
        return self.n_x * self.n_y

    @property
    def rank(self) -> int:
        return self.rank_of(self.ix, self.iy)

    def rank_of(self, ix, iy) -> int:
        """The mesh rank of block (``ix``, ``iy``)."""
        return iy * self.n_x + ix

    @property
    def role(self):
        """The block's role in ``kernels/halo_fill.py``: a ``BlockRole``, or the y
        role with one x-rank."""
        return halo_fill.block_role(self.ix, self.iy, self.n_x, self.n_y, self.nx_global)

    @property
    def fold_sources(self):
        """The x-ranks whose fold strips this block's fold reads."""
        return fold_sources(self.role, self.resolved_fold_mode)

    def fill(self, fields, save=False, saved=None):
        """The group filled in this block's role (``ops/spmd.py:fill_group``)."""
        if self.n_x == 1:
            return fill_rows(fields, self.role, self.exchange, self.rank, save, saved)
        if saved is not None:
            raise ValueError("an x-block wraps nothing before its fill")
        fields = list(fields)
        role = self.role
        plan = halo_fill.group_plan(halo_fill.group_geometry(fields, role))
        send = halo_fill.pack_strips(fields, role)
        # a top block of Ny = Hy rows reads the top rows of the blocks below its
        # strips' blocks; every block knows it from the group's geometry
        lows = self.n_y > 1 and any(f[4] == f[6] for f in fields)
        south, north, strips, below = self.exchange.rows2d(
            self, send, plan.part_len, plan.fold_len, lows)
        _, saved = halo_fill.fill_halos_group(
            fields, save=save, role=role, south=south, north=north,
            phase=halo_fill.INNER, strips=strips, lows=below)
        try:
            send = halo_fill.pack_strips(fields, role, halo_fill.COLUMNS)
            west, east = self.exchange.cols2d(self, send, plan.col_len)
            return halo_fill.fill_halos_group(fields, save=save, role=role,
                                              phase=halo_fill.OUTER, west=west,
                                              east=east, saved=saved)
        except BaseException:
            if save:  # undo the inner phase, so that the caller's restore need not
                halo_fill.restore_strips_group(fields, saved, role, halo_fill.INNER)
            raise


def _fill_copy(tensors, locs, signs, nx, ny, Hx, Hy, spmd):
    """Each of ``tensors`` copied and filled with its location and sign through
    ``fill_group``, at most ``MAX_FIELDS`` a group (one route a group). Returns the
    copies."""
    out = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
    fields = [(A, loc, sign, nx, ny, Hx, Hy) for A, loc, sign in zip(out, locs, signs)]
    for i in range(0, len(fields), halo_fill.MAX_FIELDS):
        fill_group(fields[i:i + halo_fill.MAX_FIELDS], spmd)
    return out


def fill_halos_spmd2d_groups(groups, locs, signs, nx_local, ny_local, Hx, Hy,
                             spmd: Spmd2D):
    """2-D sharded halo fill of several ``(K_i, y, x)`` stacks, each of one location
    and sign, with one route (two exchanges) for up to ``MAX_FIELDS`` of them.
    Returns the list of filled stacks, new tensors."""
    return _fill_copy(groups, locs, signs, nx_local, ny_local, Hx, Hy, spmd)


def fill_halos_spmd2d_batch(S, locs, signs, nx_local, ny_local, Hx, Hy, spmd: Spmd2D):
    """2-D sharded halo fill of a ``(K, y, x)`` stack whose planes have their own
    location and sign. Returns a new tensor."""
    return torch.stack(_fill_copy(list(S), locs, signs, nx_local, ny_local, Hx, Hy,
                                  spmd))
