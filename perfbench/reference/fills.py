"""Halo fills of the reference: the zipper fold at the north edge, the periodic x-wrap
and the zero-gradient south rows, on numpy arrays or torch tensors of layout
(..., Ny + 2·Hy, Nx + 2·Hx).

A frozen restatement of the port's plain fill (``ops/zipper.py:fill_halos``) after
``src/zipper_boundary_condition.jl``: the north halo of column i is read from the
mirrored column i' across the fold (center-x: i' = Nx - i + 1; face-x: i' = Nx - i + 2,
wrapped, with |sign| at the wrap column), times the sign (-1 for the velocity
components); center-y fields also rewrite the redundant half of row Ny. Every fill
returns a new array.
"""

from __future__ import annotations

import numpy as np
import torch


def _mirror(face_x, Nx):
    i0 = np.arange(Nx)
    return (Nx - i0) % Nx if face_x else Nx - 1 - i0


def fill(A, loc, sign, Nx, Ny, Hx, Hy, south=True):
    """``A`` with its halos filled (``loc`` = "cc", "fc", "cf" or "ff", x first; ``south``
    False leaves the south rows as they are, the grid's construction)."""
    is_t = torch.is_tensor(A)
    A = A.clone() if is_t else np.array(A, copy=True)
    face_x, face_y = loc[0] == "f", loc[1] == "f"
    if south:
        A[..., 0:Hy, :] = A[..., Hy:Hy + 1, :]
    top = A[..., Ny - 1:Hy + Ny, Hx:Hx + Nx]          # the top Hy + 1 interior rows
    idx = _mirror(face_x, Nx)
    M = top[..., torch.as_tensor(idx, device=A.device) if is_t else idx]
    i0 = np.arange(Nx)
    sign_row = np.where(face_x & (i0 == 0), float(abs(sign)), float(sign))
    upper = i0 >= Nx // 2
    if is_t:
        sign_row = torch.as_tensor(sign_row, dtype=A.dtype, device=A.device)
        upper = torch.as_tensor(upper, device=A.device)
        flip = lambda a: torch.flip(a, dims=(-2,))  # noqa: E731
        where, cat = torch.where, (lambda p: torch.cat(p, dim=-1))
    else:
        flip = lambda a: np.flip(a, axis=-2)  # noqa: E731
        where, cat = np.where, (lambda p: np.concatenate(p, axis=-1))
    if face_y:  # row Ny is kept; halo row Ny + j <- row Ny - j + 1
        rows = flip(M[..., 1:Hy + 1, :]) * sign_row
        y0 = Hy + Ny
    else:  # halo row Ny + j <- row Ny - j, and the upper half of row Ny mirrored
        new_row = where(upper, sign_row * M[..., Hy, :], top[..., Hy, :])
        halo = flip(M[..., :Hy, :]) * sign_row
        rows = (torch.cat([new_row[..., None, :], halo], dim=-2) if is_t else
                np.concatenate([new_row[..., None, :], halo], axis=-2))
        y0 = Hy + Ny - 1
    A[..., y0:Hy + Ny + Hy, :] = cat([rows[..., Nx - Hx:], rows, rows[..., :Hx]])
    A[..., :, 0:Hx] = A[..., :, Nx:Nx + Hx]
    A[..., :, Hx + Nx:Hx + Nx + Hx] = A[..., :, Hx:2 * Hx]
    return A
