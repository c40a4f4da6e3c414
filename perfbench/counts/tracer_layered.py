"""The layered tracer kernel (``csrc/tracer_adv.cu`` in layered mode with κ_h): the
horizontal tendency of every tracer in every layer.

Operations, 120 a point, layer and tracer at the N interior points: the advection
110 (two WENO-5 faces and the fluxes; as ``counts/step.py``), κ_h 9 (two gradients
of two operations, their divergence of three, its scale and its sum), the vertical
terms added 1.

Bytes: what the function needs, each on the halo-inclusive plane: per layer u and v
read; per layer and tracer the tracer and its vertical term read and its tendency
written; the 5 metric planes (the face lengths Δy at u and Δx at v, Az, Δx at u, Δy
at v) and the wet-layer counts (4 bytes a point) once. The kernel's per-layer pack
(the inverse volume and κ_h's three factors) is left out: each of its planes is made
from those, as ``counts/layered_step.py`` counts them.
"""

from perfbench.lib.shapes import of

OPS_PER_POINT_LAYER_TRACER = 110 + 9 + 1
PLANES_PER_LAYER = 2
PLANES_PER_LAYER_TRACER = 3
STATIC = 5


def count(cfg):
    """(operations, bytes) of one step's launch (every tracer)."""
    s, nz = of(cfg), cfg["nz"]
    planes = (PLANES_PER_LAYER + PLANES_PER_LAYER_TRACER * s.n_tr) * nz + STATIC
    return OPS_PER_POINT_LAYER_TRACER * s.N * nz * s.n_tr, planes * s.P * s.word + 4 * s.P
