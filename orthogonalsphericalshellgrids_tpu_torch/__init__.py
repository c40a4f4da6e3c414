"""PyTorch + CUDA port of the tripolar-grid ocean engine.

Counterpart: ``orthogonalsphericalshellgrids_tpu`` (the JAX package, the reference
this port is tested against). Same layout (``grids/ ops/ models/``) plus ``kernels/``
(Python wrappers, each beside its plain PyTorch version) and ``csrc/`` (the CUDA C++
sources, built with nvcc for sm_90a at the first CUDA use, never at import).
"""

from .grids.geometry import R_EARTH
from .grids.tripolar import TripolarGrid, build_tripolar_arrays, with_halo
from .ops.location import CC, CF, FC, FF
from .ops.zipper import fill_halos

__all__ = ["TripolarGrid", "build_tripolar_arrays", "with_halo", "fill_halos",
           "R_EARTH", "CC", "CF", "FC", "FF"]

__version__ = "0.1.0"
