"""The barotropic subcycle (``csrc/barotropic.cu``): n_sub forward-backward substeps
of (η, U, V) on the widened grid and their SM05 averages.

Operations, 20 a point and substep, at the N interior points: the divergence of the
transports (2 products with the face lengths, 2 differences, their sum, the product
with Δτ/Az) and η's update (1) make 7; each transport's update (the η difference,
its product with g·h·Δτ/Δx, the forcing added, the update) 4, so 8; the three
averages (a product and a sum each) 6. The widened halo's points, which the kernel
also steps, are not counted.

Bytes: η, U, V, GU and GV read, the three averages written, and 7 static planes read
(the face lengths Δy at u and Δx at v, Az, Δx at u, Δy at v, and the column depths
at u and v, whose signs are the masks), each once, on the widened grid.
"""

from perfbench.lib.shapes import of

OPS_PER_POINT_SUBSTEP = 20
PLANES = 5 + 3 + 7


def count(cfg):
    """(operations, bytes) of one step's subcycle."""
    s = of(cfg)
    return OPS_PER_POINT_SUBSTEP * s.n_sub * s.N, PLANES * s.Pe * s.word
