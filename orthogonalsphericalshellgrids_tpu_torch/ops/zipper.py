"""Zipper north-fold boundary condition and fused halo filling.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/zipper.py``
(``ZipperBoundaryCondition``, ``fold_strip``, ``fold_north``, ``wrap_x``,
``fill_south``, ``fill_halos``, ``fill_halos_batch``, ``fold_north_batch``) and the
fold arithmetic of ``ops/spmd2d.py:_fold_arith`` (``fold_rows``). The reference's
``ZipperBoundaryCondition`` (``src/zipper_boundary_condition.jl``): the tripolar grid
is periodic in x and folded onto itself at the north edge, so the north halo of
column i is read from the mirrored column i' on the other half of the fold, with a
sign flip for vector components.

- center-x map   i' = Nx - i + 1 (1-based)
- face-x map     i' = Nx - i + 2, wrapped periodically, with sign -> |sign| at the
                 wrap point
- center-y rows  halo row Ny+j <- row Ny-j (row Ny duplicated), plus the in-place
                 overwrite of the redundant half of row Ny: f[i,Ny] = sign*f[i',Ny]
                 for i > Nx÷2
- face-y rows    halo row Ny+j <- row Ny-j+1

Every function takes a numpy array (the float64 grid-construction path) or a torch
tensor (the model path). Both are pure data movement times ±1, so the two are
bitwise equal to each other and to the JAX package. Arrays are halo-inclusive with
layout ``(..., y, x)`` of shape ``(..., Ny + 2*Hy, Nx + 2*Hx)``.

Writes: ``fill_halos``, ``fold_north`` and ``fill_south`` copy their input first
unless ``inplace=True`` (the caller owns the buffer); ``wrap_x`` always writes in
place. The model's step fills fresh
copies in place (``kernels/halo_fill.py`` is the CUDA counterpart).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .location import CENTER, validate_location

__all__ = ["ZipperBoundaryCondition", "fold_strip", "fold_rows", "fold_north", "wrap_x",
           "fill_south", "fill_halos", "fill_halos_batch", "fold_north_batch"]


@dataclasses.dataclass(frozen=True)
class ZipperBoundaryCondition:
    """The north-fold boundary condition with an explicit sign: the reference's
    second public export (``src/OrthogonalSphericalShellGrids.jl:4``; constructor
    ``src/zipper_boundary_condition.jl:52``, default ``sign = 1``). In the fills a
    boundary condition is the (fold, sign) pair they apply; this class lets user
    code override the location's default sign (``ops/location.default_zipper_sign``)
    as in the reference, e.g. +1 on a face-located scalar."""

    sign: int = 1

    def apply(self, A, loc, grid):
        """``A`` (halo-inclusive ``(..., y, x)`` at ``loc``, numpy or torch) with its
        north halo filled across the fold with this sign, as a new array."""
        return fold_north(A, loc, self.sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy)


def _is_torch(A):
    return isinstance(A, torch.Tensor)


def _mirror(lx, Nx):
    """The fold's x-mirror: column i0 reads i0' = index[i0]."""
    i0 = np.arange(Nx)
    return Nx - 1 - i0 if lx == CENTER else (Nx - i0) % Nx


def _like(A, a):
    """A numpy array ``a`` as an array of ``A``'s kind (dtype kept for integers)."""
    if not _is_torch(A):
        return a if a.dtype.kind in "iub" else a.astype(A.dtype)
    if a.dtype.kind in "iub":
        return torch.as_tensor(a, device=A.device)
    return torch.as_tensor(a, dtype=A.dtype, device=A.device)


def _flip_rows(a):
    return torch.flip(a, dims=(-2,)) if _is_torch(a) else np.flip(a, axis=-2)


def _where(cond, a, b):
    return torch.where(cond, a, b) if _is_torch(a) else np.where(cond, a, b)


def _cat(parts, axis):
    if _is_torch(parts[0]):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def fold_strip(A, loc, sign, Nx, Ny, Hx, Hy):
    """The full-width rows the zipper fold writes, as ``(full, y0)``.

    ``full`` has shape ``(..., rf, Nx + 2*Hx)`` with ``rf = Hy + 1`` for center-y
    locations (row Ny and the halo rows) and ``rf = Hy`` for face-y; ``y0`` is the
    first written row. The strip is already periodically x-wrapped."""
    lx, ly = validate_location(loc)
    top = A[..., Ny - 1 : Hy + Ny, Hx : Hx + Nx]       # the top Hy+1 interior rows
    strip = fold_rows(top, top[..., _like(A, _mirror(lx, Nx))], loc, sign, np.arange(Nx),
                      Nx)
    if ly == CENTER:
        y0 = Hy + Ny - 1
    else:  # row Ny is kept as it is
        strip, y0 = strip[..., 1:, :], Hy + Ny
    full = _cat([strip[..., Nx - Hx :], strip, strip[..., :Hx]], axis=-1)
    return full, y0


def fold_rows(top, M, loc, sign, i0, nx_g):
    """The rows the fold writes at some columns, ``(..., Hy + 1, w)``: row Ny, then
    the Hy halo rows (``ops/spmd2d.py:_fold_arith`` of the JAX package). ``top`` is
    the top Hy + 1 interior rows at those columns, ``M`` the same rows at their
    mirror columns (the face-x roll already applied), ``i0`` the columns' global
    indices (a numpy integer array) of ``nx_g``. Row Ny keeps the columns below
    ``nx_g // 2`` and takes ``sign_row * M`` above (center-y only); face-x planes take
    ``|sign|`` at global column 0."""
    lx, ly = validate_location(loc)
    Hy = top.shape[-2] - 1
    i0 = np.asarray(i0)
    sign_row = _like(top, np.where((lx != CENTER) & (i0 == 0), float(abs(sign)),
                                   float(sign)))
    if ly == CENTER:
        halo = _flip_rows(M[..., :Hy, :]) * sign_row
        upper = _like(top, i0 >= nx_g // 2)
        new_row = _where(upper, sign_row * M[..., Hy, :], top[..., Hy, :])
    else:
        halo = _flip_rows(M[..., 1:Hy + 1, :]) * sign_row
        new_row = top[..., Hy, :]
    return _cat([new_row[..., None, :], halo], axis=-2)


def fold_north_batch(S, locs, signs, Nx, Ny, Hx, Hy):
    """The zipper fold of a ``(K, y, x)`` stack whose planes have their own location
    and sign: row Ny and the Hy north halo rows of each plane rewritten, full width
    with their wrap columns. Returns a new array (``S`` is left as it is)."""
    if len(locs) != S.shape[0] or len(signs) != S.shape[0]:
        raise ValueError(f"{S.shape[0]} planes need as many locations and signs")
    S = S.clone() if _is_torch(S) else np.array(S, copy=True)
    i0 = np.arange(Nx)
    for k, (loc, sign) in enumerate(zip(locs, signs)):
        lx, _ = validate_location(loc)
        top = S[k, Hy + Ny - 1 - Hy:Hy + Ny, Hx:Hx + Nx]
        rows = fold_rows(top, top[..., _like(S, _mirror(lx, Nx))], loc, sign, i0, Nx)
        S[k, Hy + Ny - 1:Hy + Ny + Hy, :] = _cat([rows[..., Nx - Hx:], rows,
                                                 rows[..., :Hx]], axis=-1)
    return S


def fill_halos_batch(S, locs, signs, Nx, Ny, Hx, Hy, south="zero_gradient"):
    """``fill_halos`` of a ``(K, y, x)`` stack whose planes have their own location
    and sign: the south rows, ``fold_north_batch`` and the x-wrap. Returns a new
    array."""
    if south not in ("zero_gradient", "none"):
        raise ValueError(f"Unknown south fill mode {south!r}")
    if south == "zero_gradient":
        S = S.clone() if _is_torch(S) else np.array(S, copy=True)
        S[..., 0:Hy, :] = S[..., Hy:Hy + 1, :]
    return wrap_x(fold_north_batch(S, locs, signs, Nx, Ny, Hx, Hy), Nx, Hx)


def _owned(A, inplace):
    if inplace:
        return A
    return A.clone() if _is_torch(A) else np.array(A, copy=True)


def fold_north(A, loc, sign, Nx, Ny, Hx, Hy, inplace=False):
    """The zipper fold: the north halo rows (and, at center-y locations, the
    redundant half of the last interior row) rewritten, with the periodic wrap of
    their x-halo columns (the reference's fill order: east/west after the fold,
    ``test/test_zipper_boundary_conditions.jl:39-45``). Returns the array."""
    A = _owned(A, inplace)
    full, y0 = fold_strip(A, loc, sign, Nx, Ny, Hx, Hy)
    A[..., y0:Hy + Ny + Hy, :] = full
    return A


def fill_south(A, Ny, Hy, mode, inplace=False):
    """The south halo rows: ``"zero_gradient"`` copies the first interior row into
    them; ``"none"`` leaves them (the grid-construction path; the reference leaves
    the south open, ``src/tripolar_grid.jl:149``) and returns ``A`` itself."""
    if mode == "none" or Hy == 0:
        return A
    if mode != "zero_gradient":
        raise ValueError(f"Unknown south fill mode {mode!r}")
    A = _owned(A, inplace)
    A[..., 0:Hy, :] = A[..., Hy:Hy + 1, :]
    return A


def wrap_x(A, Nx, Hx):
    """Periodic x-wrap of all rows of ``A``, in place: west halo <- last Hx interior
    columns, east halo <- first Hx interior columns. Returns ``A``."""
    A[..., :, 0:Hx] = A[..., :, Nx : Nx + Hx]
    A[..., :, Hx + Nx : Hx + Nx + Hx] = A[..., :, Hx : 2 * Hx]
    return A


def fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, south="zero_gradient", inplace=False,
               from_south=None, from_north=None):
    """Fused halo fill — south fill, north zipper fold, then periodic x-wrap — the
    single-device ``fill_halo_regions!`` of the reference on a tripolar grid.

    ``south="zero_gradient"`` copies the first interior row into the south halo;
    ``"none"`` leaves it (grid-construction path).

    On one rank of a y-partitioned run (``ops/spmd.py``) ``from_south`` and
    ``from_north`` are the ``(..., Hy, Nx+2Hx)`` rows received from the ranks below
    and above: they become the south and north halo rows in place of the south fill
    and the fold, in the order of the JAX package's ``ops/spmd.py``: the south rows,
    then the north rows or the fold (which, on a top rank of Ny = Hy rows, reads a
    received south row), then the x-wrap, which derives every written row's x-halo
    from its interior columns."""
    if south not in ("zero_gradient", "none"):
        raise ValueError(f"Unknown south fill mode {south!r}")
    if not inplace:
        A = A.clone() if _is_torch(A) else np.array(A, copy=True)
    if from_south is not None:
        A[..., 0:Hy, :] = from_south
    elif south == "zero_gradient" and Hy > 0:
        A[..., 0:Hy, :] = A[..., Hy : Hy + 1, :]
    if from_north is not None:
        A[..., Hy + Ny : Hy + Ny + Hy, :] = from_north
    elif Hy > 0:
        full, y0 = fold_strip(A, loc, sign, Nx, Ny, Hx, Hy)
        A[..., y0 : Hy + Ny + Hy, :] = full
    return wrap_x(A, Nx, Hx)
