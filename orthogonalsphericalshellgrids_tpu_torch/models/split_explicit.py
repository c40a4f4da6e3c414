"""Split-explicit free surface: substepping weights and halo-width coupling.

Counterpart: ``orthogonalsphericalshellgrids_tpu/models/split_explicit.py`` (the same
pure numpy code). Build of ``SplitExplicitFreeSurface(grid; substeps = N)`` (SURVEY.md O6).
The barotropic subsystem (η, U, V) is integrated with many short forward-backward
substeps per baroclinic step, and the results are averaged with the Shchepetkin &
McWilliams (2005) power-law weights over τ ∈ (0, 2] baroclinic steps.

The defining behavioral pins from the reference (``test/runtests.jl:52-71``):
- the free-surface fields live on a grid whose *y*-halo has been widened to
  ``Hy = len(averaging_weights) + 1`` via ``with_halo`` so the whole substep loop is
  communication-free (the substep kernel writes into the extended rows, range
  ``1:Ny+Hy-1``; validity shrinks one row per substep);
- a model without an explicit free surface configuration on a tripolar grid is an
  error.

Deliberate deviation from the reference (which keeps the x-halo unchanged and
re-applies the periodic x-wrap every substep): here the x-halo widens by the same
rule, so the substep loop is wrap-free in x too — validity shrinks one column per
substep. Bitwise-equal results, no per-substep strip writes in the barotropic
kernel, and required anyway for a fold-aware 2-D decomposition.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["SplitExplicitFreeSurface", "averaging_weights"]

# Earth-standard gravitational acceleration, the reference's default
# (Oceananigans g_Earth).
G_EARTH = 9.80665


def averaging_shape_function(tau, p=2.0, q=4.0, r=0.18927):
    """Shchepetkin & McWilliams (2005) power-law averaging kernel over τ ∈ [0, 2]
    (the same shape function Oceananigans uses for FixedSubstepNumber averaging)."""
    tau0 = (p + 2) * (p + q + 2) / ((p + 1) * (p + q + 1))
    x = tau / tau0
    return x**p * (1 - x**q) - r * x


def averaging_weights(substeps: int):
    """Fractional substep size and normalized averaging weights.

    The shape function is evaluated at the substep endpoints τ = m·Δτ, Δτ = 2/substeps;
    weights are truncated after the last positive value (the barotropic loop only runs
    that many substeps), clipped at zero, and normalized. The resulting length M sets
    the required free-surface halo: Hy = M + 1 (pinned by ``test/runtests.jl:71``).
    """
    dtau = 2.0 / substeps
    tau = dtau * np.arange(1, substeps + 1)
    w = averaging_shape_function(tau)
    pos = np.nonzero(w > 0)[0]
    if len(pos) == 0:
        raise ValueError(f"substeps={substeps} yields no positive averaging weights")
    last = pos[-1]
    w = np.clip(w[: last + 1], 0.0, None)
    w = w / w.sum()
    return dtau, w


@dataclasses.dataclass(frozen=True)
class SplitExplicitFreeSurface:
    """Configuration of the barotropic solver (static; the state lives in the model).

    ``substeps`` is the nominal substep count N (Δτ = 2Δt/N); the actual loop length is
    ``len(weights)`` (≈ 0.73·N for the SM05 kernel). ``gravitational_acceleration``
    defaults to the reference's g_Earth.
    """

    substeps: int = 30
    gravitational_acceleration: float = G_EARTH

    @property
    def fractional_dt(self) -> float:
        dtau, _ = averaging_weights(self.substeps)
        return dtau

    @property
    def weights(self) -> np.ndarray:
        _, w = averaging_weights(self.substeps)
        return w

    @property
    def n_substeps(self) -> int:
        return len(self.weights)

    @property
    def required_y_halo(self) -> int:
        """Hy = len(averaging_weights) + 1 — the reference's halo-widening rule."""
        return self.n_substeps + 1
