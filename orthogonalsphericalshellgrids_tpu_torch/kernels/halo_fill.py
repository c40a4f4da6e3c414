"""Tripolar halo fills: ``csrc/halo_fill.cu`` and its plain versions.

Counterparts: ``orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py``:

- ``fill_halos_group`` is ``fill_halos_pallas(..., save=True)`` for up to
  ``MAX_FIELDS`` fields in one launch: each field's halos are filled in place and,
  with ``save``, the pre-fill value of every cell the fill writes is first copied
  into one packed strip buffer;
- ``restore_strips_group`` is ``restore_strips_pallas``: it writes that buffer back
  into exactly the cells the fill wrote, so the unfilled fields come back bitwise;
- ``fill_halos(..., inplace=False)`` fills into a fresh buffer and leaves its input
  as it is (the diagnostics' fills).

The packed layout is the host plan's (``group_plan``): field after field, plane after
plane, and within a plane the written cells in the order of ``plane_cells`` (the
kernel's ``cell_of``). Both routes use it, so the kernel's saved buffer is bitwise the
plain version's. The plain versions gather and scatter those cells with torch
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
from . import LAUNCHES, call, check_operands, data_ptr, on_cuda

__all__ = ["fill_halos", "fill_halos_plain", "fill_halos_group", "fill_halos_group_plain",
           "restore_strips_group", "restore_strips_group_plain", "group_plan",
           "plane_cells", "MAX_FIELDS"]

MAX_FIELDS = 8
THREADS = 256  # csrc/halo_fill.cu:kThreads


class GroupPlan(NamedTuple):
    """The packed layout of a group: per field its written cells a plane, its first
    block and its first offset in the strip buffer; the launch's blocks and the
    buffer's length."""

    cells: tuple
    block0: tuple
    strip: tuple
    blocks: int
    n_saved: int


def _y0(Ny, Hy, face_y):
    return Hy + Ny if face_y else Hy + Ny - 1


def _cells(Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y):
    """Cells a fill writes in one plane: the south rows, the fold strip without the
    kept half of row Ny (center-y), the west/east columns of the rows between."""
    y0 = _y0(Ny, Hy, face_y)
    kept = 0 if face_y else Nx // 2
    return Hy * Xb + (Yb - y0) * Xb - kept + (y0 - Hy) * 2 * Hx


@functools.lru_cache(maxsize=64)
def group_plan(geoms):
    """The plan of a group, ``geoms`` a tuple of per-field
    ``(K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y)``."""
    cells, block0, strip = [], [], []
    block = off = 0
    for K, *plane in geoms:
        n = _cells(*plane)
        cells.append(n)
        block0.append(block)
        strip.append(off)
        block += -(-K * n // THREADS)
        off += K * n
    return GroupPlan(tuple(cells), tuple(block0), tuple(strip), block, off)


@functools.lru_cache(maxsize=64)
def plane_cells(Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y):
    """(y, x) of the cells a fill writes in one plane, as int64 arrays in the packed
    order of the kernel's ``cell_of``."""
    y0 = _y0(Ny, Hy, face_y)
    kept = 0 if face_y else Nx // 2
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
def _plane_geometry(name, shape, loc, Nx, Ny, Hx, Hy):
    """(K, Yb, Xb, Nx, Ny, Hx, Hy, face_x, face_y) of a field of ``shape``, checked:
    the kernel visits only written cells and reads only cells it does not write,
    which needs ``Nx`` even, ``Hy >= 1``, ``Ny > Hy + 1`` and ``2*Hx < Nx``; both
    routes check these so that a geometry the kernel refuses fails on the CPU too."""
    lx, ly = validate_location(loc)
    if Nx % 2 or Hy < 1 or Ny <= Hy + 1 or 2 * Hx >= Nx:
        raise ValueError(
            f"{name} needs Nx even, Hy >= 1, Ny > Hy + 1 and 2*Hx < Nx; got "
            f"Nx={Nx}, Ny={Ny}, Hx={Hx}, Hy={Hy}")
    if len(shape) not in (2, 3):
        raise ValueError(f"{name} takes a 2-D plane or a 3-D stack, got {len(shape)}-D")
    plane = (Ny + 2 * Hy, Nx + 2 * Hx)
    if shape[-2:] != plane:
        raise ValueError(f"{name}: a field has shape {shape}, expected planes of {plane}")
    return (shape[0] if len(shape) == 3 else 1, *plane, Nx, Ny, Hx, Hy, int(lx == FACE),
            int(ly == FACE))


def _geometry(name, A, loc, Nx, Ny, Hx, Hy):
    """The checked geometry of one field (``_plane_geometry``), its dtype and
    contiguity checked too."""
    check_operands(name, {"A": A}, A.dtype, {})
    return _plane_geometry(name, tuple(A.shape), loc, Nx, Ny, Hx, Hy)


def _group(name, fields):
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
        geoms.append(_plane_geometry(name, tuple(A.shape), loc, Nx, Ny, Hx, Hy))
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
    """The kernel's field table without the pointers: one row of 14 int64 a field
    (csrc/halo_fill.cu:Col), as bytes."""
    plan = group_plan(geoms)
    rows = []
    for (K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy), sign, n, b0, off in zip(
            geoms, signs, plan.cells, plan.block0, plan.strip):
        rows += [0, K, Yb, Xb, Nx, Ny, Hx, Hy, fx, fy, sign, n, b0, off]
    return bytes((ctypes.c_int64 * len(rows))(*rows))


def _table(fields, geoms):
    """The kernel's field table of ``fields``: the cached rows with each field's
    device address in its first column."""
    rows = _table_row0(geoms, tuple(int(f[2]) for f in fields))
    table = (ctypes.c_int64 * (len(rows) // 8)).from_buffer_copy(rows)
    for i, f in enumerate(fields):
        table[14 * i] = f[0].data_ptr()
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


def _fill_plain(fields, geoms, save):
    plan = group_plan(geoms)
    saved = _saved_buffer(fields, plan, save)
    if save:
        for A, idx, out in _strips(fields, geoms, plan, saved):
            out.copy_(A[:, idx])
    for A, loc, sign, Nx, Ny, Hx, Hy in fields:
        zipper.fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, south="zero_gradient",
                          inplace=True)
    return [f[0] for f in fields], saved


def fill_halos_group_plain(fields, save=False):
    """``fill_halos_group`` in plain PyTorch: the written cells gathered into the
    packed buffer by the plan's indices, then ``ops/zipper.fill_halos`` in place."""
    fields = list(fields)
    return _fill_plain(fields, _group("fill_halos_group", fields)[0], save)


def fill_halos_group(fields, save=False):
    """Fill the halos of every field of ``fields`` in place: a sequence of at most
    ``MAX_FIELDS`` ``(A, loc, sign, Nx, Ny, Hx, Hy)``, each ``A`` a halo-inclusive
    ``(Ny+2Hy, Nx+2Hx)`` plane or ``(K, Ny+2Hy, Nx+2Hx)`` stack, all of one dtype and
    device, contiguous, with no two sharing a byte. Returns (the same tensors, the
    packed pre-fill strips or None), one launch on a CUDA device."""
    fields = list(fields)
    geoms, cuda = _group("fill_halos_group", fields)
    if not cuda:
        return _fill_plain(fields, geoms, save)
    saved = _saved_buffer(fields, group_plan(geoms), save)
    A0 = fields[0][0]
    call("osg_halo_fill_group", A0.dtype, A0.device, _table(fields, geoms),
         len(fields), data_ptr(saved), int(save))
    LAUNCHES["halo_fill"] += 1
    return [f[0] for f in fields], saved


def _restore_group(fields, saved):
    """(fields as a list, their geometries and plan, whether on a CUDA device) of a
    restore, checked: the group as ``_group`` checks it, and ``saved`` a tensor of
    the group's dtype and device holding exactly the plan's cells."""
    fields = list(fields)
    geoms, cuda = _group("restore_strips_group", fields)
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


def restore_strips_group_plain(fields, saved):
    """``restore_strips_group`` in plain PyTorch: the packed strips scattered back by
    the plan's indices."""
    fields, geoms, plan, _ = _restore_group(fields, saved)
    return _restore_plain(fields, geoms, plan, saved)


def restore_strips_group(fields, saved):
    """Write ``saved`` (from ``fill_halos_group(fields, save=True)``) back into the
    cells the fill wrote, for every field of the same group: the pre-fill fields,
    bitwise. Reads nothing else; one launch on a CUDA device."""
    fields, geoms, plan, cuda = _restore_group(fields, saved)
    if not cuda:
        return _restore_plain(fields, geoms, plan, saved)
    A0 = fields[0][0]
    call("osg_halo_restore_group", A0.dtype, A0.device, _table(fields, geoms),
         len(fields), saved.data_ptr())
    LAUNCHES["halo_restore"] += 1
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
    call("osg_halo_fill_copy", A.dtype, A.device, A.data_ptr(), out.data_ptr(), *geom,
         int(sign))
    LAUNCHES["halo_fill_copy"] += 1
    return out
