"""Tripolar halo fill, in place or into a fresh buffer: ``csrc/halo_fill.cu`` and its
plain version.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:fill_halos_pallas``
(the aliased Pallas strip writes) and, for the out-of-place fill,
``restore_strips_pallas``: the TPU step fills a donated buffer and writes the saved
strips back to recover the unfilled field, where the port fills into a fresh buffer
and leaves the unfilled one as it is. The plain version is ``ops/zipper.fill_halos``
on an owned tensor; both kernels are bitwise equal to it at float32 and float64.
"""

from __future__ import annotations

import torch

from ..ops import zipper
from ..ops.location import FACE, validate_location
from . import LAUNCHES, call, check_operands, on_cuda

__all__ = ["fill_halos", "fill_halos_plain"]


def fill_halos_plain(A, loc, sign, Nx, Ny, Hx, Hy):
    """South zero-gradient rows, north zipper fold and periodic x-wrap, written into
    ``A`` in place (``ops/zipper.fill_halos``). Returns ``A``."""
    return zipper.fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, south="zero_gradient",
                             inplace=True)


def fill_halos(A, loc, sign, Nx, Ny, Hx, Hy, inplace=True):
    """Fill the halos of ``A`` — a halo-inclusive ``(Ny+2Hy, Nx+2Hx)`` plane or a
    ``(K, Ny+2Hy, Nx+2Hx)`` stack, filled plane by plane. With ``inplace`` the halos
    of ``A`` are written and ``A`` is returned; otherwise ``A`` is left as it is and
    a new tensor holding its interior and the filled halos is returned (one launch
    on a CUDA device, ``fill_halos_plain(A.clone(), ...)`` on the CPU).

    The in-place kernel visits only halo cells and reads only cells it does not
    write, which needs ``Nx`` even, ``Hy >= 1``, ``Ny > Hy + 1`` and ``2*Hx < Nx``;
    both routes and both modes check these so that a geometry the kernel refuses
    fails on the CPU too."""
    lx, ly = validate_location(loc)
    if Nx % 2 or Hy < 1 or Ny <= Hy + 1 or 2 * Hx >= Nx:
        raise ValueError(
            f"fill_halos needs Nx even, Hy >= 1, Ny > Hy + 1 and 2*Hx < Nx; got "
            f"Nx={Nx}, Ny={Ny}, Hx={Hx}, Hy={Hy}")
    if A.dim() not in (2, 3):
        raise ValueError(f"fill_halos takes a 2-D plane or a 3-D stack, got {A.dim()}-D")
    plane = (Ny + 2 * Hy, Nx + 2 * Hx)
    check_operands("fill_halos", {"A": A}, A.dtype, {"A": A.shape[:-2] + plane})
    if not on_cuda(A):
        return fill_halos_plain(A if inplace else A.clone(), loc, sign, Nx, Ny, Hx, Hy)
    K = A.shape[0] if A.dim() == 3 else 1
    geom = (K, plane[0], plane[1], Nx, Ny, Hx, Hy, int(lx == FACE), int(ly == FACE),
            int(sign))
    if inplace:
        call("osg_halo_fill", A.dtype, A.device, A.data_ptr(), *geom)
        LAUNCHES["halo_fill"] += 1
        return A
    out = torch.empty_like(A)
    call("osg_halo_fill_copy", A.dtype, A.device, A.data_ptr(), out.data_ptr(), *geom)
    LAUNCHES["halo_fill_copy"] += 1
    return out
