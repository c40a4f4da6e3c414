"""Horizontal Laplacian and biharmonic closures on the curvilinear C-grid.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/closures.py`` (``_ratio``,
``laplacian_u``/``_v``/``_c``, ``biharmonic_u``/``_v``/``_c``). The metric-aware
five-point Laplacian of each staggered location,

    lap(q) = [ δx( (Δy/Δx)|_e · δx q ) + δy( (Δx/Δy)|_e · δy q ) ] / Az|_L,

with free-slip masking (no flux through a solid face); the biharmonic is the
Laplacian applied twice. All operators act on halo-inclusive ``(..., y, x)`` tensors,
masks may carry a leading layer axis, and each Laplacian consumes one halo cell. The
arithmetic order matches the JAX package term for term, so eager results are bitwise
equal at float64. ν_h and κ_h ride fused in the momentum and tracer kernels; these
functions are their plain counterparts and carry the biharmonic terms, which are
plain PyTorch on the card too.
"""

from __future__ import annotations

import torch

from .operators import dxc, dxf, dyc, dyf, shift_m

__all__ = ["laplacian_u", "laplacian_v", "laplacian_c",
           "biharmonic_u", "biharmonic_v", "biharmonic_c"]

_Y = -2


def _ratio(num, den):
    """num/den with degenerate (zero-metric pole) cells mapped to 0."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(den))


def laplacian_u(grid, u, mask_u, mask_c):
    """∇²u at FC points: x-gradient at CC (masked by the cell), y-gradient at FF
    (masked by the two vertically adjacent u faces: free slip)."""
    gx = dxc(u) * _ratio(grid.dy_cc, grid.dx_cc) * mask_c
    m_ff = mask_u * shift_m(mask_u, _Y)
    gy = dyf(u) * _ratio(grid.dx_ff, grid.dy_ff) * m_ff
    return (dxf(gx) + dyc(gy)) * _ratio(1.0, grid.az_fc) * mask_u


def laplacian_v(grid, v, mask_v, mask_c):
    """∇²v at CF points: x-gradient at FF (free-slip mask from adjacent v faces),
    y-gradient at CC."""
    m_ff = mask_v * shift_m(mask_v, -1)
    gx = dxf(v) * _ratio(grid.dy_ff, grid.dx_ff) * m_ff
    gy = dyc(v) * _ratio(grid.dx_cc, grid.dy_cc) * mask_c
    return (dxc(gx) + dyf(gy)) * _ratio(1.0, grid.az_cf) * mask_v


def laplacian_c(grid, c, mask_c, mask_u, mask_v):
    """∇²c at CC points: gradients at the u/v faces, masked so no diffusive flux
    crosses a solid face."""
    gx = dxf(c) * _ratio(grid.dy_fc, grid.dx_fc) * mask_u
    gy = dyf(c) * _ratio(grid.dx_cf, grid.dy_cf) * mask_v
    return (dxc(gx) + dyc(gy)) * _ratio(1.0, grid.az_cc) * mask_c


def biharmonic_u(grid, u, mask_u, mask_c):
    """∇⁴u at FC points (∇² twice with identical free-slip masking); the tendency
    takes −ν4_h·∇⁴u."""
    return laplacian_u(grid, laplacian_u(grid, u, mask_u, mask_c), mask_u, mask_c)


def biharmonic_v(grid, v, mask_v, mask_c):
    """∇⁴v at CF points."""
    return laplacian_v(grid, laplacian_v(grid, v, mask_v, mask_c), mask_v, mask_c)


def biharmonic_c(grid, c, mask_c, mask_u, mask_v):
    """∇⁴c at CC points."""
    return laplacian_c(grid, laplacian_c(grid, c, mask_c, mask_u, mask_v),
                       mask_c, mask_u, mask_v)
