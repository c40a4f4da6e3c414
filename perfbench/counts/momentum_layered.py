"""The layered momentum kernel (``csrc/momentum.cu`` over a layer stack, with its
closure pack): the horizontal momentum tendency of every layer.

Operations, 166 a point and layer at the N interior points: the vector-invariant
advection 130 (the vorticity, û, v̂, two WENO-5 reconstructions, the kinetic energy;
as ``counts/step.py``), the ν_h Laplacians 16 (two gradients of two operations and
their divergence of four, for each component), the quadratic drag 16 (the speed of
six and its product of two, for each component), the vertical terms added and the
mask applied 4.

Bytes: what the function needs, each on the halo-inclusive plane: per layer u and v
and the two vertical terms read, Gu and Gv written; the 8 metric planes and the
wet-layer counts (4 bytes a point) once. The kernel's closure pack and closing masks
are left out: each of their planes is made from the metrics, the layer thicknesses
and the wet-layer counts, as ``counts/layered_step.py`` counts them.
"""

from perfbench.lib.shapes import of

OPS_PER_POINT_LAYER = 130 + 16 + 16 + 4
PLANES_PER_LAYER = 2 + 2 + 2
STATIC = 8


def count(cfg):
    """(operations, bytes) of one step's launch."""
    s, nz = of(cfg), cfg["nz"]
    planes = PLANES_PER_LAYER * nz + STATIC
    return OPS_PER_POINT_LAYER * s.N * nz, planes * s.P * s.word + 4 * s.P
