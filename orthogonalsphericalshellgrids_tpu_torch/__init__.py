"""PyTorch + CUDA port of the tripolar-grid ocean engine.

Counterpart: ``orthogonalsphericalshellgrids_tpu`` (the JAX package, the reference
this port is tested against). Same layout (``grids/ ops/ models/``) plus ``kernels/``
(Python wrappers, each beside its plain PyTorch version) and ``csrc/`` (the CUDA C++
sources, built with nvcc for sm_90a at the first CUDA use, never at import).

The reference exports exactly ``TripolarGrid`` and ``ZipperBoundaryCondition``
(``src/OrthogonalSphericalShellGrids.jl:4``); this package exports the same names as
the JAX package's ``__init__.py``.
"""

from .grids.geometry import R_EARTH
from .grids.tripolar import TripolarGrid, build_tripolar_arrays, with_halo
from .ops.location import CC, CF, FC, FF, default_zipper_sign, sign_for_field_name
from .ops.zipper import ZipperBoundaryCondition, fill_halos, fold_north, wrap_x

__all__ = [
    "TripolarGrid",
    "ZipperBoundaryCondition",
    "build_tripolar_arrays",
    "with_halo",
    "fill_halos",
    "fold_north",
    "wrap_x",
    "default_zipper_sign",
    "sign_for_field_name",
    "R_EARTH",
    "CC", "CF", "FC", "FF",
]

__version__ = "0.1.0"
