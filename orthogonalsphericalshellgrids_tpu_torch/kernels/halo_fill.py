"""Tripolar halo fills: ``csrc/halo_fill.cu`` and its plain versions.

Counterparts: ``orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py``:

- ``fill_halos_group`` is ``fill_halos_pallas(..., save=True)`` for up to
  ``MAX_FIELDS`` fields in one launch: each field's halos are filled in place and,
  with ``save``, the pre-fill value of every cell the fill writes is first copied
  into one packed strip buffer;
- ``restore_strips_group`` is ``restore_strips_pallas``: it writes that buffer back
  into exactly the cells the fill wrote, so the unfilled fields come back bitwise;
- ``fill_halos(..., inplace=False)`` fills into a fresh buffer and leaves its input
  as it is (the diagnostics' fills);
- on one rank of a y-partitioned run (``ops/spmd.py``) the group fill takes the
  rank's role (``SINGLE``, ``BOTTOM``, ``MIDDLE``, ``TOP``) and the rows received
  from its neighbours, and ``pack_strips`` packs the rows it sends them: the
  counterpart of ``orthogonalsphericalshellgrids_tpu/ops/spmd.py:
  fill_halos_spmd_groups``, whose XLA fill the JAX package's sharded step runs;
- on one block of a 2-D (x, y) mesh (``ops/spmd2d.py``) the role is a ``BlockRole``
  (the y role, the x-ranks, the block's x-rank, the global columns) and the fill
  runs in two phases: ``INNER`` (the y rows and the fold, from the received rows and
  the top ranks' fold strips) and, after the x exchange, ``OUTER`` (every x-halo
  cell from the x-neighbours' columns); ``pack_strips`` packs the rows with the fold
  strip, or the columns: the counterpart of ``orthogonalsphericalshellgrids_tpu/
  ops/spmd2d.py:fill_halos_spmd2d_groups``;
- the overlap split of a y-partitioned rank wraps x locally before its exchange
  (phase ``WRAP``) and fills the rest after it (``NO_WRAP``); each phase saves the
  cells it writes into one packed buffer (``saved``), so one restore gives the
  fields back.

The packed layout is the host plan's (``group_plan``): field after field, plane after
plane, and within a plane the written cells in the order of ``plane_cells`` (the
kernel's ``cell_of``). Both routes use it, so the kernel's saved buffer is bitwise the
plain version's. A role without the fold (``BOTTOM``, ``MIDDLE``) writes the Hy north
rows in full and, of row Ny, only its halo columns, so its cells are laid out as a
face-y field's. The send and receive buffers hold each field's K planes of Hy
full-width rows, field after field (the plan's ``xoff``); the send buffer holds the
top Hy interior rows of every field (for the rank above), then the bottom Hy (for the
rank below), and on an x-block then its fold strip, the rows Ny-1 .. Ny+Hy-1 at the
interior columns (the plan's ``fold``). An x-block's column buffers hold each field's
K planes of Yb rows of Hx columns (the plan's ``cols``): its last Hx interior columns
(for the rank east of it), then its first Hx (for the rank west of it). The plain
versions gather and scatter those cells with torch indexing and fill with
``ops/zipper.py``; every kernel is bitwise equal to them at float32 and float64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import zipper
from ..ops.location import FACE, validate_location
from . import call, check_operands, count, data_ptr, on_cuda

__all__ = ["fill_halos", "fill_halos_plain", "fill_halos_group", "fill_halos_group_plain",
           "restore_strips_group", "restore_strips_group_plain", "pack_strips",
           "pack_strips_plain", "wrap_halos_group", "group_plan", "group_geometry",
           "plane_cells", "role_of", "block_role",
           "BlockRole", "MAX_FIELDS", "SINGLE", "BOTTOM", "MIDDLE", "TOP", "ALL", "WRAP",
           "NO_WRAP", "INNER", "OUTER", "ROWS", "COLUMNS"]

MAX_FIELDS = 8
MAX_RANKS_X = 32  # csrc/halo_fill.cu:kMaxRanksX
THREADS = 256  # csrc/halo_fill.cu:kThreads
# the shard roles (csrc/halo_fill.cu:Role): the whole grid; rank 0 of several; a rank
# between two others; the last rank, which holds the fold
SINGLE, BOTTOM, MIDDLE, TOP = range(4)
ROLE_NAMES = ("single", "bottom", "middle", "top")
# the cells of the plan a launch writes (csrc/halo_fill.cu:Phase): all; the x-halo
# columns of the rows between the south and north strips (a local x-wrap); all but
# those; an x-block's interior columns; its x-halo columns
ALL, WRAP, NO_WRAP, INNER, OUTER = range(5)
PHASE_NAMES = ("all", "wrap", "no_wrap", "inner", "outer")
# what pack_strips copies (csrc/halo_fill.cu:PackKind)
ROWS, COLUMNS = range(2)
TABLE_COLS = 21  # csrc/halo_fill.cu:kCols


class BlockRole(NamedTuple):
    """The role of one block of a 2-D (x, y) mesh: ``y`` its y role (``role_of`` of
    its y-rank), ``n_x`` the x-ranks, ``ix`` its x-rank and ``nx_global`` the global
    interior columns (``n_x`` times the block's)."""

    y: int
    n_x: int
    ix: int
    nx_global: int


def role_of(rank, n_shards):
    """The role of rank ``rank`` of ``n_shards`` y-partitioned ranks."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} is not one of {n_shards} ranks")
    if n_shards == 1:
        return SINGLE
    return BOTTOM if rank == 0 else TOP if rank == n_shards - 1 else MIDDLE


def block_role(ix, iy, n_x, n_y, nx_global):
    """The role of block (``ix``, ``iy``) of an (``n_x``, ``n_y``) mesh of
    ``nx_global`` columns: its y role with one x-rank, else a ``BlockRole``."""
    if not 0 <= ix < n_x:
        raise ValueError(f"x-rank {ix} is not one of {n_x}")
    y = role_of(iy, n_y)
    return y if n_x == 1 else BlockRole(y, n_x, ix, nx_global)


def _split(role, Nx):
    """(y role, x-ranks, x-rank, global columns) of ``role`` on a field of ``Nx``
    interior columns."""
    if isinstance(role, BlockRole):
        return role
    return role, 1, 0, Nx


def _y_role(role):
    return role.y if isinstance(role, BlockRole) else role


def receives(role):
    """(whether the role receives its south rows, whether its north rows)."""
    y = _y_role(role)
    return y in (MIDDLE, TOP), y in (BOTTOM, MIDDLE)


class GroupPlan(NamedTuple):
    """The packed layout of a group: per field its written cells a plane, its first
    block, its first offset in the strip buffer and its first offset in the send
    and receive buffers; the launch's blocks, the strip buffer's length and the
    length of one part of the send buffer (one direction's rows); per field its
    first offset in a rank's fold strip and in the column buffers, the length of a
    rank's fold strip and of one part of the column buffers."""

    cells: tuple
    block0: tuple
    strip: tuple
    xoff: tuple
    blocks: int
    n_saved: int
    part_len: int
    fold: tuple = ()
    cols: tuple = ()
    fold_len: int = 0
    col_len: int = 0


def _y0_kept(Nx, Ny, Hy, face_y, role):
    """The first row of the north strip and the cells of it a fill keeps: row Ny and
    its kept part for a center-y fold (the columns below the global middle); row
    Ny + 1 and none otherwise."""
    y, n_x, ix, nx_g = _split(role, Nx)
    if face_y or y in (BOTTOM, MIDDLE):
        return Hy + Ny, 0
    return Hy + Ny - 1, min(max(nx_g // 2 - ix * Nx, 0), Nx)


def _cells(Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, role=SINGLE):
    """Cells a fill writes in one plane: the south rows, the north strip (the fold
    strip without the kept half of row Ny, or the received rows), the west/east
    columns of the rows between."""
    y0, kept = _y0_kept(Nx, Ny, Hy, face_y, role)
    return Hy * Xb + (Yb - y0) * Xb - kept + (y0 - Hy) * 2 * Hx


@functools.lru_cache(maxsize=64)
def group_plan(geoms):
    """The plan of a group, ``geoms`` a tuple of per-field
    ``(K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y[, role])``."""
    cells, block0, strip, xoff, fold, cols = [], [], [], [], [], []
    block = off = rows = folds = columns = 0
    for K, *plane in geoms:
        Yb, Xb, Nx, Ny, Hx, Hy = plane[:6]
        n = _cells(*plane)
        cells.append(n)
        block0.append(block)
        strip.append(off)
        xoff.append(rows)
        fold.append(folds)
        cols.append(columns)
        block += -(-K * n // THREADS)
        off += K * n
        rows += K * Hy * Xb  # K planes of Hy rows of Xb
        folds += K * (Hy + 1) * Nx  # K planes of Hy + 1 rows of Nx
        columns += K * Yb * Hx  # K planes of Yb rows of Hx
    return GroupPlan(tuple(cells), tuple(block0), tuple(strip), tuple(xoff), block, off,
                     rows, tuple(fold), tuple(cols), folds, columns)


@functools.lru_cache(maxsize=64)
def plane_cells(Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, role=SINGLE):
    """(y, x) of the cells a fill writes in one plane, as int64 arrays in the packed
    order of the kernel's ``cell_of``."""
    y0, kept = _y0_kept(Nx, Ny, Hy, face_y, role)
    south = np.arange(Hy * Xb)
    row_ny = np.concatenate([np.arange(Hx), np.arange(Hx + kept, Xb)])
    north = np.arange((Yb - y0 - 1) * Xb)
    mid = np.arange((y0 - Hy) * 2 * Hx)
    c = mid % (2 * Hx)
    y = np.concatenate([south // Xb, np.full(row_ny.size, y0), y0 + 1 + north // Xb,
                        Hy + mid // (2 * Hx)])
    x = np.concatenate([south % Xb, row_ny, north % Xb, np.where(c < Hx, c, Nx + c)])
    return y.astype(np.int64), x.astype(np.int64)


@functools.lru_cache(maxsize=64)
def _phase_cells(plane, phase):
    """(flat indices in the plane, positions in the plane's packed cells) of the
    cells of ``plane`` (the geometry less K) that a launch of ``phase`` writes
    (csrc/halo_fill.cu:in_phase)."""
    Yb, Xb, Nx, Ny, Hx, Hy, _, face_y, role = plane
    y, x = plane_cells(*plane)
    outer = (x < Hx) | (x >= Hx + Nx)
    wrap = outer & (y >= Hy) & (y < _y0_kept(Nx, Ny, Hy, face_y, role)[0])
    keep = {ALL: np.ones_like(outer), WRAP: wrap, NO_WRAP: ~wrap, INNER: ~outer,
            OUTER: outer}[phase]
    return y[keep] * Xb + x[keep], np.flatnonzero(keep)


@functools.lru_cache(maxsize=64)
def _flat_cells(plane, device, phase=ALL):
    idx, pos = _phase_cells(plane, phase)
    return torch.as_tensor(idx, device=device), torch.as_tensor(pos, device=device)


@functools.lru_cache(maxsize=256)
def _plane_geometry(name, shape, loc, Nx, Ny, Hx, Hy, role=SINGLE):
    """(K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, role) of a field of ``shape``,
    checked: the kernel visits only written cells and reads only cells it does not
    write, which needs ``Nx`` even, ``Hy >= 1``, ``2*Hx < Nx`` and ``Ny > Hy + 1``
    where one plane has both the south fill and the fold (``SINGLE``); a shard's
    received rows come from the receive buffers, and its send rows must be interior
    rows, so a shard needs ``Ny >= Hy`` (every decomposition the JAX package takes).
    An x-block reads its fold from the strips and its x halos from the received
    columns, so it needs only an even global width, ``Nx >= Hx`` (its x sends are
    interior columns) and ``Ny >= Hy``, or ``Ny > Hy`` where its one row of blocks
    folds (the strip is Hy + 1 interior rows). Both routes check these so that a
    geometry the kernel refuses fails on the CPU too."""
    lx, ly = validate_location(loc)
    y, n_x, ix, nx_g = _split(role, Nx)
    if y not in (SINGLE, BOTTOM, MIDDLE, TOP):
        raise ValueError(f"{name}: unknown shard role {role!r}")
    if n_x == 1:
        if isinstance(role, BlockRole):
            raise ValueError(f"{name}: a mesh of one x-rank takes the y role itself")
        rows_ok = Ny > Hy + 1 if y == SINGLE else Ny >= Hy
        if Nx % 2 or Hy < 1 or not rows_ok or 2 * Hx >= Nx:
            need = "Ny > Hy + 1" if y == SINGLE else "Ny >= Hy"
            raise ValueError(
                f"{name} ({ROLE_NAMES[y]}) needs Nx even, Hy >= 1, {need} and "
                f"2*Hx < Nx; got Nx={Nx}, Ny={Ny}, Hx={Hx}, Hy={Hy}")
    else:
        if not 1 < n_x <= MAX_RANKS_X or not 0 <= ix < n_x or nx_g != n_x * Nx:
            raise ValueError(f"{name}: block {ix} of {n_x} x-ranks of {Nx} columns "
                             f"cannot cover {nx_g} global columns (at most "
                             f"{MAX_RANKS_X} x-ranks)")
        alone = y == SINGLE  # a top rank of several reads the rank below its strip
        if nx_g % 2 or Hy < 1 or Hx < 1 or Nx < Hx or Ny < Hy + alone:
            need = "Ny > Hy (the fold strip is Hy + 1 interior rows)" if alone else \
                "Ny >= Hy"
            raise ValueError(
                f"{name} ({ROLE_NAMES[y]} x-block) needs an even global width, Hx, Hy "
                f">= 1, Nx >= Hx and {need}; got Nx={Nx} of {nx_g}, Ny={Ny}, Hx={Hx}, "
                f"Hy={Hy}")
    if len(shape) not in (2, 3):
        raise ValueError(f"{name} takes a 2-D plane or a 3-D stack, got {len(shape)}-D")
    plane = (Ny + 2 * Hy, Nx + 2 * Hx)
    if shape[-2:] != plane:
        raise ValueError(f"{name}: a field has shape {shape}, expected planes of {plane}")
    return (shape[0] if len(shape) == 3 else 1, *plane, Nx, Ny, Hx, Hy, int(lx == FACE),
            int(ly == FACE), role)


def _geometry(name, A, loc, Nx, Ny, Hx, Hy, role=SINGLE):
    """The checked geometry of one field (``_plane_geometry``), its dtype and
    contiguity checked too."""
    check_operands(name, {"A": A}, A.dtype, {})
    return _plane_geometry(name, tuple(A.shape), loc, Nx, Ny, Hx, Hy, role)


def _group(name, fields, role=SINGLE):
    """The geometries of a group of ``(A, loc, sign, Nx, Ny, Hx, Hy)`` and whether it
    lies on a CUDA device, checked: at most ``MAX_FIELDS`` fields, one dtype float32
    or float64, one device, each contiguous, and no two fields' bytes overlapping
    (views of one buffer are fine where they are disjoint)."""
    if not 1 <= len(fields) <= MAX_FIELDS:
        raise ValueError(f"{name} takes 1 to {MAX_FIELDS} fields, got {len(fields)}")
    A0 = fields[0][0]
    dtype, device = A0.dtype, A0.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype must be float32 or float64, got {dtype}")
    geoms, spans = [], []
    for i, (A, loc, _, Nx, Ny, Hx, Hy) in enumerate(fields):
        if A.dtype != dtype:
            raise TypeError(f"{name}: field {i} has dtype {A.dtype}, expected {dtype}")
        if A.device != device:
            raise ValueError(f"{name}: field {i} lies on {A.device}, field 0 on {device}")
        if not A.is_contiguous():
            raise ValueError(f"{name}: field {i} must be contiguous")
        geoms.append(_plane_geometry(name, tuple(A.shape), loc, Nx, Ny, Hx, Hy, role))
        start = A.data_ptr()
        spans.append((start, start + A.numel() * A.element_size(), i))
    spans.sort()
    for (_, end, i), (start, _, j) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError(f"{name}: fields {min(i, j)} and {max(i, j)} overlap in "
                             f"memory")
    return tuple(geoms), on_cuda(A0)


def group_geometry(fields, role=SINGLE):
    """The checked geometries of a group in ``role`` (``group_plan`` takes them)."""
    return _group("group_geometry", list(fields), role)[0]


@functools.lru_cache(maxsize=64)
def _table_row0(geoms, signs):
    """The kernel's field table without the pointers: one row of ``TABLE_COLS``
    int64 a field (csrc/halo_fill.cu:Col), as bytes."""
    plan = group_plan(geoms)
    rows = []
    for (K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, role), sign, n, b0, off, xoff, fo, co in zip(
            geoms, signs, plan.cells, plan.block0, plan.strip, plan.xoff, plan.fold,
            plan.cols):
        y, n_x, ix, nx_g = _split(role, Nx)
        rows += [0, K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, sign, n, b0, off, y, xoff, n_x, ix,
                 nx_g, fo, co]
    return bytes((ctypes.c_int64 * len(rows))(*rows))


def _table(fields, geoms):
    """The kernel's field table of ``fields``: the cached rows with each field's
    device address in its first column."""
    rows = _table_row0(geoms, tuple(int(f[2]) for f in fields))
    table = (ctypes.c_int64 * (len(rows) // 8)).from_buffer_copy(rows)
    for i, f in enumerate(fields):
        table[TABLE_COLS * i] = f[0].data_ptr()
    return table


def _scatter_save(fields, geoms, plan, saved, phase):
    """Copy the pre-fill values of the cells ``phase`` writes into ``saved``."""
    for (A, *_), geom, n, off in zip(fields, geoms, plan.cells, plan.strip):
        idx, pos = _flat_cells(geom[1:], A.device, phase)
        saved[off:off + geom[0] * n].view(geom[0], n)[:, pos] = A.view(geom[0], -1)[:, idx]


def _saved_buffer(fields, plan, save, saved=None):
    """The packed buffer a fill saves into: ``saved`` (a buffer of the plan an
    earlier phase made), or a new one with ``save``, or None."""
    A0 = fields[0][0]
    if saved is not None:
        if not save:
            raise ValueError("fill_halos_group: a saved buffer goes with save=True")
        check_operands("fill_halos_group", {"saved": saved}, A0.dtype,
                       {"saved": (plan.n_saved,)})
        on_cuda(A0, saved)  # raises when the buffer lies on another device
        return saved
    return torch.empty(plan.n_saved, dtype=A0.dtype, device=A0.device) if save else None


def _rows(buf, A, geom, xoff):
    """The rows of field ``A`` in a send or receive buffer: ``(..., Hy, Xb)``."""
    K, Hy, Xb = geom[0], geom[6], geom[2]
    return buf[xoff:xoff + K * Hy * Xb].view(A.shape[:-2] + (Hy, Xb))


def _columns(buf, A, geom, coff):
    """The columns of field ``A`` in a column buffer: ``(..., Yb, Hx)``."""
    K, Yb, Hx = geom[0], geom[1], geom[5]
    return buf[coff:coff + K * Yb * Hx].view(A.shape[:-2] + (Yb, Hx))


def _mirror_strip(A, geom, foff, xoff, strips, lows):
    """The fold's mirror of an x-block's columns, ``(..., Hy + 1, Nx)``: the top
    ranks' fold strips laid side by side into the global strip (zero where a rank's
    strip was not received; with Ny = Hy the lowest row from the top interior row of
    the rank below, in ``lows``) and indexed at the mirror of each of the block's
    global columns (``ops/spmd2d.py:_fold_arith``'s ``M``), with the global
    columns."""
    K, _, Xb, Nx, Ny, Hx, Hy, face_x, _, role = geom
    n = K * (Hy + 1) * Nx
    shape = A.shape[:-2] + (Hy + 1, Nx)
    parts = []
    for q, st in enumerate(strips):
        if st is None:
            parts.append(A.new_zeros(shape))
            continue
        part = st[foff:foff + n].view(shape)
        if Ny == Hy:
            part = part.clone()
            part[..., 0, :] = lows[q][xoff:xoff + K * Hy * Xb].view(
                A.shape[:-2] + (Hy, Xb))[..., Hy - 1, Hx:Hx + Nx]
        parts.append(part)
    full = torch.cat(parts, dim=-1)
    ig = role.ix * Nx + np.arange(Nx)
    nx_g = role.nx_global
    mir = (nx_g - ig) % nx_g if face_x else nx_g - 1 - ig
    return full[..., torch.as_tensor(mir, device=A.device)], ig


def _fill_inner(A, loc, sign, geom, south, north, strips, lows, foff, xoff):
    """The ``INNER`` phase of an x-block in place: the south rows (received or
    zero-gradient), then the north rows (received) or the fold from the strips, at
    the interior columns."""
    Nx, Ny, Hx, Hy = geom[3:7]
    inner = slice(Hx, Hx + Nx)
    if south is not None:
        A[..., :Hy, inner] = south[..., inner]
    else:
        A[..., :Hy, inner] = A[..., Hy:Hy + 1, inner]
    if north is not None:
        A[..., Hy + Ny:, inner] = north[..., inner]
    else:
        M, ig = _mirror_strip(A, geom, foff, xoff, strips, lows)
        top = A[..., Ny - 1:Ny + Hy, inner]
        A[..., Hy + Ny - 1:, inner] = zipper.fold_rows(top, M, loc, sign, ig,
                                                       geom[9].nx_global)


def _fill_plain(fields, geoms, save, recv, phase, saved=None):
    """The plain fill of ``phase``: the written cells saved into the packed buffer by
    the plan's indices, then ``ops/zipper.fill_halos`` in place with the received
    rows (``ALL``, ``NO_WRAP``, which writes the wrapped columns again with the
    values ``WRAP`` wrote), the local wrap of the middle rows (``WRAP``), or an
    x-block's phases."""
    plan = group_plan(geoms)
    saved = _saved_buffer(fields, plan, save, saved)
    if save:
        _scatter_save(fields, geoms, plan, saved, phase)
    for (A, loc, sign, Nx, Ny, Hx, Hy), geom, xoff, foff, coff in zip(
            fields, geoms, plan.xoff, plan.fold, plan.cols):
        south, north, west, east = (None if recv[k] is None else fn(recv[k], A, geom, o)
                                    for k, fn, o in (("south", _rows, xoff),
                                                     ("north", _rows, xoff),
                                                     ("west", _columns, coff),
                                                     ("east", _columns, coff)))
        if phase == WRAP:
            y0 = _y0_kept(Nx, Ny, Hy, geom[8], geom[9])[0]
            zipper.wrap_x(A[..., Hy:y0, :], Nx, Hx)
        elif phase == INNER:
            _fill_inner(A, loc, sign, geom, south, north, recv["strips"], recv["lows"],
                        foff, xoff)
        elif phase == OUTER:
            A[..., :, :Hx] = west
            A[..., :, Hx + Nx:] = east
        else:
            zipper.fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, south="zero_gradient",
                              inplace=True, from_south=south, from_north=north)
    return [f[0] for f in fields], saved


def _receive_group(name, fields, role, phase, recv):
    """The checked geometries of a group filled in role ``role`` and phase
    ``phase`` and whether it lies on a CUDA device: the group as ``_group`` checks
    it; the phase one of the role's (``ALL``, ``WRAP``, ``NO_WRAP`` for a
    y-partitioned rank, ``INNER``, ``OUTER`` for an x-block); the receive buffers the
    phase reads (and no other), each of the group's dtype and device, contiguous,
    holding one part of the plan's send buffer; and on the fold of an x-block the
    fold strips of the x-ranks it reads, a rank's fold strip each."""
    geoms, cuda = _group(name, fields, role)
    plan = group_plan(geoms)
    A0 = fields[0][0]
    block = isinstance(role, BlockRole)
    if phase not in ((INNER, OUTER) if block else (ALL, WRAP, NO_WRAP)):
        raise ValueError(f"{name}: phase {phase!r} is not one of a "
                         f"{'block' if block else 'y-partitioned rank'}'s")
    rows = phase in (ALL, NO_WRAP, INNER)
    want = dict(zip(("south", "north"), (rows and r for r in receives(role))),
                west=phase == OUTER, east=phase == OUTER)
    lens = dict(south=plan.part_len, north=plan.part_len, west=plan.col_len,
                east=plan.col_len)
    for side, wanted in want.items():
        buf = recv[side]
        if (buf is not None) != wanted:
            raise ValueError(f"{name}: a {ROLE_NAMES[_y_role(role)]} rank's "
                             f"{PHASE_NAMES[phase]} phase "
                             f"{'reads' if wanted else 'reads no'} {side} buffer")
        if buf is not None:
            check_operands(name, {side: buf}, A0.dtype, {side: (lens[side],)})
            on_cuda(A0, buf)  # raises when the buffer lies on another device
    strips, lows = recv["strips"], recv["lows"]
    fold = block and phase == INNER and role.y in (SINGLE, TOP)
    low = fold and any(g[4] == g[6] for g in geoms)
    for what, bufs, wanted, n in (("fold strips", strips, fold, plan.fold_len),
                                  ("rows below the strips", lows, low, plan.part_len)):
        if (bufs is not None) != wanted:
            raise ValueError(f"{name}: this launch {'reads' if wanted else 'reads no'} "
                             f"the top ranks' {what}")
        if not wanted:
            continue
        if len(bufs) != role.n_x:
            raise ValueError(f"{name}: {len(bufs)} ranks' {what}, not {role.n_x}")
        Nx = geoms[0][3]
        ig = role.ix * Nx + np.arange(Nx)
        nx_g = role.nx_global
        for q in np.unique(np.concatenate([(nx_g - 1 - ig) // Nx,
                                           ((nx_g - ig) % nx_g) // Nx])):
            if bufs[q] is None:
                raise ValueError(f"{name}: the fold of x-rank {role.ix} reads x-rank "
                                 f"{q}'s {what}")
        for b in bufs:
            if b is not None:
                check_operands(name, {what: b}, A0.dtype, {what: (n,)})
                on_cuda(A0, b)
    return geoms, cuda


def fill_halos_group_plain(fields, save=False, role=SINGLE, south=None, north=None, *,
                           phase=ALL, west=None, east=None, strips=None, lows=None,
                           saved=None):
    """``fill_halos_group`` in plain PyTorch: the written cells gathered into the
    packed buffer by the plan's indices, then ``ops/zipper.fill_halos`` in place
    (with the received rows of a shard), or the phase of an x-block from its
    received rows, columns and fold strips (``ops/zipper.fold_rows``)."""
    fields = list(fields)
    recv = dict(south=south, north=north, west=west, east=east, strips=strips, lows=lows)
    geoms, _ = _receive_group("fill_halos_group", fields, role, phase, recv)
    return _fill_plain(fields, geoms, save, recv, phase, saved)


def fill_halos_group(fields, save=False, role=SINGLE, south=None, north=None, *,
                     phase=ALL, west=None, east=None, strips=None, lows=None, saved=None):
    """Fill the halos of every field of ``fields`` in place: a sequence of at most
    ``MAX_FIELDS`` ``(A, loc, sign, Nx, Ny, Hx, Hy)``, each ``A`` a halo-inclusive
    ``(Ny+2Hy, Nx+2Hx)`` plane or ``(K, Ny+2Hy, Nx+2Hx)`` stack, all of one dtype and
    device, contiguous, with no two sharing a byte. Returns (the same tensors, the
    packed pre-fill strips or None), one launch on a CUDA device.

    On one rank of a y-partitioned run, ``role`` is the rank's role (``role_of``) and
    ``Ny`` its own rows; ``south`` and ``north`` are the rows received from the ranks
    below and above (one part of their ``pack_strips`` buffers; None where the role
    has no such neighbour). They fill the south and north halo rows in place of the
    south fill and the fold. ``phase`` ``WRAP`` writes only the local x-wrap of the
    rows between the south and north strips (it reads no buffer), ``NO_WRAP`` the
    rest.

    On one block of a 2-D mesh, ``role`` is a ``BlockRole`` and ``Nx`` the block's
    columns; ``phase`` ``INNER`` fills the interior columns of the y rows from
    ``south``/``north`` and, on the top row of blocks, the fold from ``strips`` (a
    list of the ``n_x`` top ranks' fold strips, None for those it does not read,
    ``ops/spmd2d.fold_sources``; and where a field has Ny = Hy, ``lows``, the send buffers of
    the ranks below those, whose top row is the lowest row of the strip); ``OUTER``
    fills every x-halo cell from ``west`` and ``east`` (one part of the
    x-neighbours' column buffers).

    ``saved`` is the packed buffer an earlier phase of the same fill returned: this
    phase saves its cells into it (``save`` must be set). Each phase saves only the
    cells it writes, so one ``restore_strips_group`` undoes all phases."""
    recv = dict(south=south, north=north, west=west, east=east, strips=strips, lows=lows)
    return _fill_group(list(fields), save, role, phase, recv, saved)


def _fill_group(fields, save, role, phase, recv, saved):
    geoms, cuda = _receive_group("fill_halos_group", fields, role, phase, recv)
    if not cuda:
        return _fill_plain(fields, geoms, save, recv, phase, saved)
    strips, lows, south, north, west, east = (
        recv[k] for k in ("strips", "lows", "south", "north", "west", "east"))
    saved = _saved_buffer(fields, group_plan(geoms), save, saved)
    A0 = fields[0][0]
    ranks = [None if bufs is None else (ctypes.c_int64 * len(bufs))(
        *(0 if b is None else b.data_ptr() for b in bufs)) for bufs in (strips, lows)]
    call("osg_halo_fill_group", A0.dtype, A0.device, _table(fields, geoms),
         len(fields), data_ptr(saved), int(save), data_ptr(south), data_ptr(north),
         data_ptr(west), data_ptr(east), *ranks, phase)
    count("halo_fill_block" if isinstance(role, BlockRole) else "halo_wrap"
          if phase == WRAP else "halo_fill" if role == SINGLE else "halo_fill_shard")
    return [f[0] for f in fields], saved


def wrap_halos_group(fields, role):
    """The local x-wrap of a y-partitioned rank's group, in place: the x-halo
    columns of the rows between the south and north strips from the rows' own
    columns, their old values saved into a new packed buffer of the group's plan,
    which is returned for ``fill_halos_group(..., phase=NO_WRAP, saved=)`` to
    complete (``fill_halos_group`` with ``phase=WRAP``; one launch on a CUDA
    device)."""
    recv = dict(south=None, north=None, west=None, east=None, strips=None, lows=None)
    return _fill_group(list(fields), True, role, WRAP, recv, None)[1]


def _pack_geoms(fields, role, kind):
    """The checked geometries of a pack and whether it lies on a CUDA device: rows
    for any rank but a single one (an x-block's include its fold strip), columns for
    an x-block only."""
    block = isinstance(role, BlockRole)
    if kind == ROWS and role == SINGLE:
        raise ValueError("pack_strips: a single rank sends nothing")
    if kind not in (ROWS, COLUMNS) or (kind == COLUMNS and not block):
        raise ValueError(f"pack_strips: kind {kind!r} is not one of a "
                         f"{'block' if block else 'y-partitioned rank'}'s")
    return _group("pack_strips", fields, role)


def pack_strips_plain(fields, role, kind=ROWS):
    """``pack_strips`` in plain PyTorch: one ``torch.cat`` of the rows (and fold
    strips) or of the columns."""
    fields = list(fields)
    _pack_geoms(fields, role, kind)
    if kind == COLUMNS:
        rights = [f[0][..., :, f[3]:f[3] + f[5]].reshape(-1) for f in fields]
        lefts = [f[0][..., :, f[5]:2 * f[5]].reshape(-1) for f in fields]
        return torch.cat(rights + lefts)
    tops = [f[0][..., f[4]:f[4] + f[6], :].reshape(-1) for f in fields]
    bottoms = [f[0][..., f[6]:2 * f[6], :].reshape(-1) for f in fields]
    folds = []
    if isinstance(role, BlockRole):
        folds = [f[0][..., f[4] - 1:f[4] + f[6], f[5]:f[5] + f[3]].reshape(-1)
                 for f in fields]
    return torch.cat(tops + bottoms + folds)


def pack_strips(fields, role, kind=ROWS):
    """The send buffer of a shard's group (fields as ``fill_halos_group`` takes them,
    ``role`` not ``SINGLE``): every field's top Hy interior rows (rows Ny .. Ny+Hy-1,
    for the rank above), then every field's bottom Hy interior rows (rows Hy ..
    2Hy-1, for the rank below), each part field after field at the plan's ``xoff``,
    taken before any fill rewrites a row; on an x-block then every field's fold strip
    (rows Ny-1 .. Ny+Hy-1 at the interior columns, at the plan's ``fold``). With
    ``kind=COLUMNS`` (an x-block, after its ``INNER`` phase): every field's last Hx
    interior columns of all rows (for the rank east of it), then its first Hx (for
    the rank west of it), at the plan's ``cols``. One launch on a CUDA device."""
    fields = list(fields)
    geoms, cuda = _pack_geoms(fields, role, kind)
    if not cuda:
        return pack_strips_plain(fields, role, kind)
    plan = group_plan(geoms)
    n = (2 * plan.col_len if kind == COLUMNS else
         2 * plan.part_len + (plan.fold_len if isinstance(role, BlockRole) else 0))
    A0 = fields[0][0]
    send = torch.empty(n, dtype=A0.dtype, device=A0.device)
    call("osg_halo_pack_group", A0.dtype, A0.device, _table(fields, geoms), len(fields),
         send.data_ptr(), kind)
    count("halo_pack_block" if isinstance(role, BlockRole) else "halo_pack")
    return send


def _restore_group(fields, saved, role, phase=ALL):
    """(fields as a list, their geometries and plan, whether on a CUDA device) of a
    restore, checked: the group as ``_group`` checks it, ``phase`` one of the
    phases, and ``saved`` a tensor of the group's dtype and device holding exactly
    the plan's cells."""
    if phase not in (ALL, WRAP, NO_WRAP, INNER, OUTER):
        raise ValueError(f"restore_strips_group: unknown phase {phase!r}")
    fields = list(fields)
    geoms, cuda = _group("restore_strips_group", fields, role)
    plan = group_plan(geoms)
    if not torch.is_tensor(saved):
        raise TypeError("restore_strips_group: saved must be the tensor that "
                        "fill_halos_group(..., save=True) returned")
    check_operands("restore_strips_group", {"saved": saved}, fields[0][0].dtype,
                   {"saved": (plan.n_saved,)})
    on_cuda(fields[0][0], saved)  # raises when saved lies on another device
    return fields, geoms, plan, cuda


def _restore_plain(fields, geoms, plan, saved, phase):
    for (A, *_), geom, n, off in zip(fields, geoms, plan.cells, plan.strip):
        idx, pos = _flat_cells(geom[1:], A.device, phase)
        A.view(geom[0], -1)[:, idx] = saved[off:off + geom[0] * n].view(geom[0], n)[:, pos]
    return [f[0] for f in fields]


def restore_strips_group_plain(fields, saved, role=SINGLE, phase=ALL):
    """``restore_strips_group`` in plain PyTorch: the packed strips scattered back by
    the plan's indices."""
    fields, geoms, plan, _ = _restore_group(fields, saved, role, phase)
    return _restore_plain(fields, geoms, plan, saved, phase)


def restore_strips_group(fields, saved, role=SINGLE, phase=ALL):
    """Write ``saved`` (from ``fill_halos_group(fields, save=True, role=role)``, all
    its phases) back into the cells the fill wrote, for every field of the same
    group: the pre-fill fields, bitwise. With ``phase`` only the cells of that
    phase (a fill that stopped after it). Reads nothing else; one launch on a CUDA
    device."""
    fields, geoms, plan, cuda = _restore_group(fields, saved, role, phase)
    if not cuda:
        return _restore_plain(fields, geoms, plan, saved, phase)
    A0 = fields[0][0]
    call("osg_halo_restore_group", A0.dtype, A0.device, _table(fields, geoms),
         len(fields), saved.data_ptr(), phase)
    count("halo_restore")
    return [f[0] for f in fields]


def fill_halos_plain(A, loc, sign, Nx, Ny, Hx, Hy):
    """South zero-gradient rows, north zipper fold and periodic x-wrap, written into
    ``A`` in place (``ops/zipper.fill_halos``). Returns ``A``."""
    return zipper.fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, south="zero_gradient",
                             inplace=True)


def fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, inplace=True):
    """Fill the halos of ``A`` — a halo-inclusive ``(Ny+2Hy, Nx+2Hx)`` plane or a
    ``(K, Ny+2Hy, Nx+2Hx)`` stack, filled plane by plane. With ``inplace`` the halos
    of ``A`` are written and ``A`` is returned (a group of one, ``fill_halos_group``);
    otherwise ``A`` is left as it is and a new tensor holding its interior and the
    filled halos is returned (one launch on a CUDA device,
    ``fill_halos_plain(A.clone(), ...)`` on the CPU)."""
    if inplace:
        return fill_halos_group([(A, loc, sign, Nx, Ny, Hx, Hy)])[0][0]
    geom = _geometry("fill_halos", A, loc, Nx, Ny, Hx, Hy)
    if not on_cuda(A):
        return fill_halos_plain(A.clone(), loc, sign, Nx, Ny, Hx, Hy)
    out = torch.empty_like(A)
    call("osg_halo_fill_copy", A.dtype, A.device, A.data_ptr(), out.data_ptr(),
         *geom[:9], int(sign))
    count("halo_fill_copy")
    return out
