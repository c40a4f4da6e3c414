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
  fill_halos_spmd_groups``, whose XLA fill the JAX package's sharded step runs.

The packed layout is the host plan's (``group_plan``): field after field, plane after
plane, and within a plane the written cells in the order of ``plane_cells`` (the
kernel's ``cell_of``). Both routes use it, so the kernel's saved buffer is bitwise the
plain version's. A role without the fold (``BOTTOM``, ``MIDDLE``) writes the Hy north
rows in full and, of row Ny, only its halo columns, so its cells are laid out as a
face-y field's. The send and receive buffers hold each field's K planes of Hy
full-width rows, field after field (the plan's ``xoff``); the send buffer holds the
top Hy interior rows of every field (for the rank above), then the bottom Hy (for the
rank below). The plain versions gather and scatter those cells with torch
indexing and fill with ``ops/zipper.fill_halos``; every kernel is bitwise equal to
them at float32 and float64.
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
           "pack_strips_plain", "group_plan", "plane_cells", "role_of", "MAX_FIELDS",
           "SINGLE", "BOTTOM", "MIDDLE", "TOP"]

MAX_FIELDS = 8
THREADS = 256  # csrc/halo_fill.cu:kThreads
# the shard roles (csrc/halo_fill.cu:Role): the whole grid; rank 0 of several; a rank
# between two others; the last rank, which holds the fold
SINGLE, BOTTOM, MIDDLE, TOP = range(4)
ROLE_NAMES = ("single", "bottom", "middle", "top")
TABLE_COLS = 16  # csrc/halo_fill.cu:kCols


def role_of(rank, n_shards):
    """The role of rank ``rank`` of ``n_shards`` y-partitioned ranks."""
    if not 0 <= rank < n_shards:
        raise ValueError(f"rank {rank} is not one of {n_shards} ranks")
    if n_shards == 1:
        return SINGLE
    return BOTTOM if rank == 0 else TOP if rank == n_shards - 1 else MIDDLE


def receives(role):
    """(whether the role receives its south rows, whether its north rows)."""
    return role in (MIDDLE, TOP), role in (BOTTOM, MIDDLE)


class GroupPlan(NamedTuple):
    """The packed layout of a group: per field its written cells a plane, its first
    block, its first offset in the strip buffer and its first offset in the send
    and receive buffers; the launch's blocks, the strip buffer's length and the
    length of one part of the send buffer (one direction's rows)."""

    cells: tuple
    block0: tuple
    strip: tuple
    xoff: tuple
    blocks: int
    n_saved: int
    part_len: int


def _y0_kept(Nx, Ny, Hy, face_y, role):
    """The first row of the north strip and the cells of it a fill keeps: row Ny and
    its kept half for a center-y fold; row Ny + 1 and none otherwise."""
    if face_y or role in (BOTTOM, MIDDLE):
        return Hy + Ny, 0
    return Hy + Ny - 1, Nx // 2


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
    cells, block0, strip, xoff = [], [], [], []
    block = off = rows = 0
    for K, *plane in geoms:
        n = _cells(*plane)
        cells.append(n)
        block0.append(block)
        strip.append(off)
        xoff.append(rows)
        block += -(-K * n // THREADS)
        off += K * n
        rows += K * plane[5] * plane[1]  # K planes of Hy rows of Xb
    return GroupPlan(tuple(cells), tuple(block0), tuple(strip), tuple(xoff), block, off,
                     rows)


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
def _flat_cells(plane, device):
    y, x = plane_cells(*plane)
    return torch.as_tensor(y * plane[1] + x, device=device)


@functools.lru_cache(maxsize=256)
def _plane_geometry(name, shape, loc, Nx, Ny, Hx, Hy, role=SINGLE):
    """(K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y, role) of a field of ``shape``,
    checked: the kernel visits only written cells and reads only cells it does not
    write, which needs ``Nx`` even, ``Hy >= 1``, ``2*Hx < Nx`` and ``Ny > Hy + 1``
    where one plane has both the south fill and the fold (``SINGLE``); a shard's
    received rows come from the receive buffers, and its send rows must be interior
    rows, so a shard needs ``Ny >= Hy`` (every decomposition the JAX package takes).
    Both routes check these so that a geometry the kernel refuses fails on the CPU
    too."""
    lx, ly = validate_location(loc)
    if role not in (SINGLE, BOTTOM, MIDDLE, TOP):
        raise ValueError(f"{name}: unknown shard role {role!r}")
    rows_ok = Ny > Hy + 1 if role == SINGLE else Ny >= Hy
    if Nx % 2 or Hy < 1 or not rows_ok or 2 * Hx >= Nx:
        need = "Ny > Hy + 1" if role == SINGLE else "Ny >= Hy"
        raise ValueError(
            f"{name} ({ROLE_NAMES[role]}) needs Nx even, Hy >= 1, {need} and "
            f"2*Hx < Nx; got Nx={Nx}, Ny={Ny}, Hx={Hx}, Hy={Hy}")
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


@functools.lru_cache(maxsize=64)
def _table_row0(geoms, signs):
    """The kernel's field table without the pointers: one row of ``TABLE_COLS``
    int64 a field (csrc/halo_fill.cu:Col), as bytes."""
    plan = group_plan(geoms)
    rows = []
    for (K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, role), sign, n, b0, off, xoff in zip(
            geoms, signs, plan.cells, plan.block0, plan.strip, plan.xoff):
        rows += [0, K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, sign, n, b0, off, role, xoff]
    return bytes((ctypes.c_int64 * len(rows))(*rows))


def _table(fields, geoms):
    """The kernel's field table of ``fields``: the cached rows with each field's
    device address in its first column."""
    rows = _table_row0(geoms, tuple(int(f[2]) for f in fields))
    table = (ctypes.c_int64 * (len(rows) // 8)).from_buffer_copy(rows)
    for i, f in enumerate(fields):
        table[TABLE_COLS * i] = f[0].data_ptr()
    return table


def _strips(fields, geoms, plan, saved):
    """Per field: (A as (K, Yb*Xb), the flat indices of its written cells, its slice
    of ``saved`` as (K, cells))."""
    for (A, *_), geom, n, off in zip(fields, geoms, plan.cells, plan.strip):
        K = geom[0]
        yield (A.view(K, -1), _flat_cells(geom[1:], A.device),
               saved[off:off + K * n].view(K, n))


def _saved_buffer(fields, plan, save):
    A0 = fields[0][0]
    return torch.empty(plan.n_saved, dtype=A0.dtype, device=A0.device) if save else None


def _rows(buf, A, geom, xoff):
    """The rows of field ``A`` in a send or receive buffer: ``(..., Hy, Xb)``."""
    K, Hy, Xb = geom[0], geom[6], geom[2]
    return buf[xoff:xoff + K * Hy * Xb].view(A.shape[:-2] + (Hy, Xb))


def _fill_plain(fields, geoms, save, south=None, north=None):
    plan = group_plan(geoms)
    saved = _saved_buffer(fields, plan, save)
    if save:
        for A, idx, out in _strips(fields, geoms, plan, saved):
            out.copy_(A[:, idx])
    for (A, loc, sign, Nx, Ny, Hx, Hy), geom, xoff in zip(fields, geoms, plan.xoff):
        zipper.fill_halos(
            A, loc, sign, Nx, Ny, Hx, Hy, south="zero_gradient", inplace=True,
            from_south=None if south is None else _rows(south, A, geom, xoff),
            from_north=None if north is None else _rows(north, A, geom, xoff))
    return [f[0] for f in fields], saved


def _shard_group(name, fields, role, south, north):
    """The checked geometries of a group filled in role ``role`` and whether it lies
    on a CUDA device: the group as ``_group`` checks it, and the receive buffers the
    role reads (and no other), each of the group's dtype and device, contiguous,
    holding one part of the plan's send buffer."""
    geoms, cuda = _group(name, fields, role)
    plan = group_plan(geoms)
    A0 = fields[0][0]
    for side, buf, wanted in zip(("south", "north"), (south, north), receives(role)):
        if (buf is not None) != wanted:
            raise ValueError(f"{name}: a {ROLE_NAMES[role]} rank "
                             f"{'receives' if wanted else 'receives no'} {side} rows")
        if buf is not None:
            check_operands(name, {side: buf}, A0.dtype, {side: (plan.part_len,)})
            on_cuda(A0, buf)  # raises when the buffer lies on another device
    return geoms, cuda


def fill_halos_group_plain(fields, save=False, role=SINGLE, south=None, north=None):
    """``fill_halos_group`` in plain PyTorch: the written cells gathered into the
    packed buffer by the plan's indices, then ``ops/zipper.fill_halos`` in place
    (with the received rows of a shard)."""
    fields = list(fields)
    geoms, _ = _shard_group("fill_halos_group", fields, role, south, north)
    return _fill_plain(fields, geoms, save, south, north)


def fill_halos_group(fields, save=False, role=SINGLE, south=None, north=None):
    """Fill the halos of every field of ``fields`` in place: a sequence of at most
    ``MAX_FIELDS`` ``(A, loc, sign, Nx, Ny, Hx, Hy)``, each ``A`` a halo-inclusive
    ``(Ny+2Hy, Nx+2Hx)`` plane or ``(K, Ny+2Hy, Nx+2Hx)`` stack, all of one dtype and
    device, contiguous, with no two sharing a byte. Returns (the same tensors, the
    packed pre-fill strips or None), one launch on a CUDA device.

    On one rank of a y-partitioned run, ``role`` is the rank's role (``role_of``) and
    ``Ny`` its own rows; ``south`` and ``north`` are the rows received from the ranks
    below and above (one part of their ``pack_strips`` buffers; None where the role
    has no such neighbour). They fill the south and north halo rows in place of the
    south fill and the fold."""
    fields = list(fields)
    geoms, cuda = _shard_group("fill_halos_group", fields, role, south, north)
    if not cuda:
        return _fill_plain(fields, geoms, save, south, north)
    saved = _saved_buffer(fields, group_plan(geoms), save)
    A0 = fields[0][0]
    call("osg_halo_fill_group", A0.dtype, A0.device, _table(fields, geoms),
         len(fields), data_ptr(saved), int(save), data_ptr(south), data_ptr(north))
    count("halo_fill" if role == SINGLE else "halo_fill_shard")
    return [f[0] for f in fields], saved


def pack_strips_plain(fields, role):
    """``pack_strips`` in plain PyTorch: one ``torch.cat`` of the rows."""
    fields = list(fields)
    _group("pack_strips", fields, role)
    tops = [f[0][..., f[4]:f[4] + f[6], :].reshape(-1) for f in fields]
    bottoms = [f[0][..., f[6]:2 * f[6], :].reshape(-1) for f in fields]
    return torch.cat(tops + bottoms)


def pack_strips(fields, role):
    """The send buffer of a shard's group (fields as ``fill_halos_group`` takes them,
    ``role`` not ``SINGLE``): every field's top Hy interior rows (rows Ny .. Ny+Hy-1,
    for the rank above), then every field's bottom Hy interior rows (rows Hy ..
    2Hy-1, for the rank below), each part field after field at the plan's ``xoff``,
    taken before any fill rewrites a row. One launch on a CUDA device."""
    fields = list(fields)
    if role == SINGLE:
        raise ValueError("pack_strips: a single rank sends nothing")
    geoms, cuda = _group("pack_strips", fields, role)
    if not cuda:
        return pack_strips_plain(fields, role)
    A0 = fields[0][0]
    send = torch.empty(2 * group_plan(geoms).part_len, dtype=A0.dtype, device=A0.device)
    call("osg_halo_pack_group", A0.dtype, A0.device, _table(fields, geoms), len(fields),
         send.data_ptr())
    count("halo_pack")
    return send


def _restore_group(fields, saved, role):
    """(fields as a list, their geometries and plan, whether on a CUDA device) of a
    restore, checked: the group as ``_group`` checks it, and ``saved`` a tensor of
    the group's dtype and device holding exactly the plan's cells."""
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


def _restore_plain(fields, geoms, plan, saved):
    for A, idx, strip in _strips(fields, geoms, plan, saved):
        A[:, idx] = strip
    return [f[0] for f in fields]


def restore_strips_group_plain(fields, saved, role=SINGLE):
    """``restore_strips_group`` in plain PyTorch: the packed strips scattered back by
    the plan's indices."""
    fields, geoms, plan, _ = _restore_group(fields, saved, role)
    return _restore_plain(fields, geoms, plan, saved)


def restore_strips_group(fields, saved, role=SINGLE):
    """Write ``saved`` (from ``fill_halos_group(fields, save=True, role=role)``)
    back into the cells the fill wrote, for every field of the same group: the
    pre-fill fields, bitwise. Reads nothing else; one launch on a CUDA device."""
    fields, geoms, plan, cuda = _restore_group(fields, saved, role)
    if not cuda:
        return _restore_plain(fields, geoms, plan, saved)
    A0 = fields[0][0]
    call("osg_halo_restore_group", A0.dtype, A0.device, _table(fields, geoms),
         len(fields), saved.data_ptr())
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
