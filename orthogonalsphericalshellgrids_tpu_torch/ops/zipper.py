"""Zipper north-fold boundary condition and fused halo filling.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/zipper.py`` (``fold_strip``,
``wrap_x``, ``fill_halos``; ``fold_north`` and ``fill_south`` are folded into
``fill_halos``). The reference's
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

Writes: ``fill_halos`` copies its input first unless ``inplace=True`` (the caller
owns the buffer); ``wrap_x`` always writes in place. The model's step fills fresh
copies in place (``kernels/halo_fill.py`` is the CUDA counterpart).
"""

from __future__ import annotations

import numpy as np
import torch

from .location import CENTER, validate_location

__all__ = ["fold_strip", "wrap_x", "fill_halos"]


def _is_torch(A):
    return isinstance(A, torch.Tensor)


def _mirror(lx, sign, Nx):
    """(index, sign_row) of the fold's x-mirror: column i0 reads i0' = index[i0] and
    is multiplied by sign_row[i0] (|sign| at the face-x wrap point,
    ``src/zipper_boundary_condition.jl:74,:91``)."""
    i0 = np.arange(Nx)
    if lx == CENTER:
        return Nx - 1 - i0, np.full(Nx, float(sign))
    return (Nx - i0) % Nx, np.where(i0 == 0, float(abs(sign)), float(sign))


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
    idx, sign_row = _mirror(lx, sign, Nx)
    M = top[..., _like(A, idx)]
    sign_row = _like(A, sign_row)
    if ly == CENTER:
        halo = _flip_rows(M[..., :Hy, :]) * sign_row
        # redundant-half overwrite of row Ny for i0 >= Nx//2, from pre-update values
        upper = _like(A, np.arange(Nx) >= Nx // 2)
        new_row = _where(upper, sign_row * M[..., Hy, :], top[..., Hy, :])
        strip = _cat([new_row[..., None, :], halo], axis=-2)
        y0 = Hy + Ny - 1
    else:
        strip = _flip_rows(M[..., 1 : Hy + 1, :]) * sign_row
        y0 = Hy + Ny
    full = _cat([strip[..., Nx - Hx :], strip, strip[..., :Hx]], axis=-1)
    return full, y0


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
