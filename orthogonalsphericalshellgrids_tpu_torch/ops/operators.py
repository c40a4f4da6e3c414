"""Staggered C-grid difference and interpolation operators.

Counterpart: ``orthogonalsphericalshellgrids_tpu/ops/operators.py``. All operators act
on halo-inclusive tensors with layout ``(..., y, x)`` and are shape-preserving
``torch.roll`` shifts, so one operator costs one halo cell of validity.

Index convention (0-based): a face-x located value ``f[..., i]`` sits between centers
``i-1`` and ``i``; likewise in y. The arithmetic order matches the JAX package term
for term, so eager results are bitwise equal at float64.
"""

from __future__ import annotations

import torch

__all__ = [
    "shift_m", "shift_p",
    "dxc", "dxf", "dyc", "dyf",
    "ixc", "ixf", "iyc", "iyf",
]

_X = -1
_Y = -2


def shift_p(a, axis):
    """out[k] = a[k+1] (wraps at the array edge; only halo cells become invalid)."""
    return torch.roll(a, -1, dims=axis)


def shift_m(a, axis):
    """out[k] = a[k-1]."""
    return torch.roll(a, 1, dims=axis)


def dxc(f):
    """δx Face->Center: out[i] = f[i+1] - f[i]."""
    return shift_p(f, _X) - f


def dxf(c):
    """δx Center->Face: out[i] = c[i] - c[i-1]."""
    return c - shift_m(c, _X)


def dyc(f):
    return shift_p(f, _Y) - f


def dyf(c):
    return c - shift_m(c, _Y)


def ixc(f):
    """ℑx Face->Center: out[i] = (f[i] + f[i+1]) / 2."""
    return 0.5 * (f + shift_p(f, _X))


def ixf(c):
    """ℑx Center->Face: out[i] = (c[i-1] + c[i]) / 2."""
    return 0.5 * (c + shift_m(c, _X))


def iyc(f):
    return 0.5 * (f + shift_p(f, _Y))


def iyf(c):
    return 0.5 * (c + shift_m(c, _Y))
