"""The vertical kernel (``csrc/vertical.cu``) as the implicit configurations run it:
the terms that couple the layers, without the explicit ν_v and κ_v.

Operations, a point and layer at the N interior points: w from continuity 8 (the two
transports, their differences and sum, the scale, the running sum), its advection of
u and v 12 (for each component the difference, its scale, the mean of w and the
product of five, and their share of one), the linear equation of state 7 and the
hydrostatic pressure and its gradient 10 (the running sum of three, two gradients of
three, one spare), the centred vertical flux of each tracer 6 (the mean, the product,
the divergence of three).

Bytes: per layer u, v and each tracer read and their three terms written; the 5 metric
planes and the wet-layer counts (4 bytes a point) once; each on the halo-inclusive
plane.
"""

from perfbench.lib.shapes import of

OPS_PER_POINT_LAYER = 8 + 12 + 7 + 10
OPS_PER_POINT_LAYER_TRACER = 6
STATIC = 5


def count(cfg):
    """(operations, bytes) of one step's launch."""
    s, nz = of(cfg), cfg["nz"]
    ops = (OPS_PER_POINT_LAYER + OPS_PER_POINT_LAYER_TRACER * s.n_tr) * s.N * nz
    planes = 2 * (2 + s.n_tr) * nz + STATIC
    return ops, planes * s.P * s.word + 4 * s.P
