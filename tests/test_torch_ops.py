"""The PyTorch port's ops against the JAX package called eagerly, at float64 exactly.

ops/zipper (fill_halos on torch tensors and on numpy arrays), ops/operators and the
WENO-5 reconstructions of ops/advection. Eager JAX runs one primitive at a time, so
its float64 results are bitwise those of the same operation order in PyTorch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orthogonalsphericalshellgrids_tpu.ops import advection as jadv
from orthogonalsphericalshellgrids_tpu.ops import operators as jops
from orthogonalsphericalshellgrids_tpu.ops import zipper as jzip
from orthogonalsphericalshellgrids_tpu_torch.ops import advection as tadv
from orthogonalsphericalshellgrids_tpu_torch.ops import operators as tops
from orthogonalsphericalshellgrids_tpu_torch.ops import zipper as tzip
from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC, FF

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("H", [5, 22])
@pytest.mark.parametrize("loc", [CC, FC, CF, FF])
@pytest.mark.parametrize("sign", [1, -1])
def test_fill_halos_exact(H, loc, sign):
    Nx, Ny = 48, 40
    A = _rand((Ny + 2 * H, Nx + 2 * H), seed=H + 7 * (sign + 1))
    want = np.asarray(jzip.fill_halos(jnp.asarray(A), loc, sign, Nx, Ny, H, H,
                                      south="zero_gradient", xp=jnp))
    At = torch.as_tensor(A)
    got = tzip.fill_halos(At, loc, sign, Nx, Ny, H, H)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(At, torch.as_tensor(A)), "inplace=False must not write the input"
    # the numpy path (grid construction) and in-place writes agree too
    got_np = tzip.fill_halos(A.copy(), loc, sign, Nx, Ny, H, H, inplace=True)
    np.testing.assert_array_equal(got_np, want)
    B = At.clone()
    tzip.fill_halos(B, loc, sign, Nx, Ny, H, H, inplace=True)
    assert torch.equal(B, got)


def test_fill_halos_stack_and_south_none():
    """Leading dimensions ride along; south='none' leaves the south rows alone."""
    Nx, Ny, H = 36, 20, 4
    A = _rand((3, Ny + 2 * H, Nx + 2 * H), seed=3)
    for south in ("zero_gradient", "none"):
        want = np.asarray(jzip.fill_halos(jnp.asarray(A), CF, -1, Nx, Ny, H, H,
                                          south=south, xp=jnp))
        got = tzip.fill_halos(torch.as_tensor(A), CF, -1, Nx, Ny, H, H, south=south)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["dxc", "dxf", "dyc", "dyf", "ixc", "ixf", "iyc", "iyf"])
def test_operators_exact(name):
    A = _rand((2, 30, 44), seed=11)
    want = np.asarray(getattr(jops, name)(jnp.asarray(A)))
    got = getattr(tops, name)(torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("fn", ["weno5_upwind_faces_from_centers",
                                "weno5_upwind_centers_from_faces"])
def test_weno5_exact(fn, axis):
    c = _rand((60, 80), seed=1)
    vel = _rand((60, 80), seed=2)
    want = np.asarray(getattr(jadv, fn)(jnp.asarray(c), jnp.asarray(vel), axis))
    got = getattr(tadv, fn)(torch.as_tensor(c), torch.as_tensor(vel), axis).numpy()
    np.testing.assert_array_equal(got, want)
