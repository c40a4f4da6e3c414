"""The barotropic kernel's launch plan (``kernels/barotropic.py:launch_plan``) on the CPU.

The plan is checked directly (every substep once and in order, tiles that cover the
plane, shared memory within the H100's 227 KB per block), and the time-tiled
algorithm of ``csrc/barotropic.cu`` is replayed here in PyTorch, tile by tile and
launch by launch at float64: each CTA's window with its ring of ``k`` cells, the
clamped neighbours at the window's edge, zeros outside the array, the periodic
columns of the x-wrap and the seam's east flux. The replay must give the plain
version's averages on the valid region (band 1e-12: dtau is folded into the
factors), hold a wrapped halo column bitwise equal to the column it copies, stay
finite everywhere and give the same bits under two different plans.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch.kernels import barotropic  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (  # noqa: E402
    averaging_weights)

DTYPES = [torch.float32, torch.float64]
MAIN = (724, 1484)
SMEM_PER_BLOCK = 232448  # the H100's shared memory per block, bytes


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_sub", [1, 2, 6, 7, 8, 13, 14, 15, 21, 22, 36, 50, 100])
def test_plan_runs_every_substep_once_in_order(dtype, n_sub):
    plan = barotropic.launch_plan(*MAIN, n_sub, dtype)
    flat = [m for m0, m1 in plan.launches for m in range(m0, m1)]
    assert flat == list(range(n_sub))
    k_max = barotropic.K_MAX[dtype]
    assert all(0 < m1 - m0 <= plan.k <= k_max for m0, m1 in plan.launches)
    assert len(plan.launches) == -(-n_sub // k_max)  # the fewest launches


def test_plan_of_the_main_path():
    """21 substeps at float32: two launches, of 11 and 10 substeps, over 26 x 42 tiles
    of 48 x 64 windows, 512 threads each."""
    assert len(averaging_weights(30)[1]) == 21
    plan = barotropic.launch_plan(*MAIN, 21, torch.float32)
    assert plan.launches == ((0, 11), (11, 21))
    assert (plan.window, plan.tile, plan.grid, plan.threads) == ((48, 64), (26, 42),
                                                                 (28, 36), 512)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [MAIN, (76, 92), (134, 224), (1, 1), (10, 12),
                                   (61, 97), (500, 3)])
def test_plan_tiles_cover_the_plane(dtype, shape):
    for n_sub in (1, 7, 21, 36):
        plan = barotropic.launch_plan(*shape, n_sub, dtype)
        (TY, TX), (GY, GX), (WY, WX) = plan.tile, plan.grid, plan.window
        assert (TY, TX) == (WY - 2 * plan.k, WX - 2 * plan.k) and min(TY, TX) >= 1
        # the tiles cover every cell, and no tile lies wholly outside the plane
        assert GY * TY >= shape[0] and (GY - 1) * TY < shape[0]
        assert GX * TX >= shape[1] and (GX - 1) * TX < shape[1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_shared_memory(dtype):
    for n_sub in (1, 7, 21, 36, 100):
        plan = barotropic.launch_plan(*MAIN, n_sub, dtype)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert plan.threads <= 1024


def replay(static, eta, U, V, GU, GV, dtau, weights, Nx, Hx, wrap, plan):
    """The tile algorithm of csrc/barotropic.cu, one window at a time."""
    Ye, Xe = eta.shape
    (WY, WX), (TY, TX), k = plan.window, plan.tile, plan.k
    dy_fc, dx_cf, inv_az, gh_u, gh_v, inv_dx, inv_dy, mask_u, mask_v = static
    planes = (dy_fc, dx_cf, dtau * inv_az, dtau * gh_u * inv_dx, dtau * gh_v * inv_dy,
              mask_u, mask_v, dtau * GU, dtau * GV)
    state = (eta, U, V)
    acc = torch.zeros((3, Ye, Xe), dtype=eta.dtype)
    ty, tx = torch.arange(WY), torch.arange(WX)
    for m0, m1 in plan.launches:
        nxt = torch.zeros((3, Ye, Xe), dtype=eta.dtype)
        for by in range(plan.grid[0]):
            for bx in range(plan.grid[1]):
                rows, L = by * TY - k + ty, bx * TX - k + tx
                gx = Hx + (L - Hx) % Nx if wrap else L
                inside = ((rows >= 0) & (rows < Ye))[:, None] & (
                    torch.ones(WX, dtype=torch.bool) if wrap else (L >= 0) & (L < Xe))[None]
                r, c = rows.clamp(0, Ye - 1), gx.clamp(0, Xe - 1)

                def win(A, cols=c):
                    return torch.where(inside, A[r][:, cols], torch.zeros((), dtype=A.dtype))

                dy, dx, caz, cu, cv, mu, mv, gu, gv = (win(p) for p in planes)
                e, u, v = (win(s) for s in state)
                seam = (gx == Hx) if wrap else torch.zeros(WX, dtype=torch.bool)
                east = torch.full((WX,), min(Hx + Nx, Xe - 1))
                seam_dy, seam_u0 = win(dy_fc, east), win(U, east)
                tile = ((ty >= k) & (ty < WY - k) & (rows < Ye))[:, None] & (
                    (tx >= k) & (tx < WX - k) & (L < Xe))[None]
                Lc = L.clamp(0, Xe - 1)
                a = torch.where(tile, acc[:, r][:, :, Lc], 0.0) if m0 > 0 else \
                    torch.zeros((3, WY, WX), dtype=eta.dtype)
                for m in range(m0, m1):
                    fx, fy = dy * u, dx * v
                    pub = torch.where(seam, seam_dy * (seam_u0 if m == 0 else u), fx)
                    fx_e = torch.cat([pub[:, 1:], pub[:, -1:]], 1)
                    fy_n = torch.cat([fy[1:], fy[-1:]], 0)
                    e = e - caz * ((fx_e - fx) + (fy_n - fy))
                    e_w = torch.cat([e[:, :1], e[:, :-1]], 1)
                    e_s = torch.cat([e[:1], e[:-1]], 0)
                    u = (u - (cu * (e - e_w) - gu)) * mu
                    v = (v - (cv * (e - e_s) - gv)) * mv
                    w = weights[m]
                    a = a + w * torch.stack([e, u, v])
                ii, jj = torch.nonzero(tile, as_tuple=True)
                acc[:, rows[ii], L[jj]] = a[:, ii, jj]
                nxt[:, rows[ii], L[jj]] = torch.stack([e, u, v])[:, ii, jj]
        state = tuple(nxt)
    return acc


def _inputs(Ny, Nx, H, seed):
    """Random planes on an (Ny + 2H, Nx + 2H) grid; the masks are 0 and 1, and gh_u
    is not 0 where mask_u is (nothing may assume h_u = 0 on land)."""
    r = np.random.default_rng(seed)
    Ye, Xe = Ny + 2 * H, Nx + 2 * H
    static = 0.5 + r.random((9, Ye, Xe))
    static[7:] = static[7:] > 0.6
    eta, U, V = 0.01 * r.standard_normal((3, Ye, Xe))
    GU, GV = 1e-3 * r.standard_normal((2, Ye, Xe))
    return [torch.as_tensor(a) for a in (static, eta, U, V, GU, GV)]


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("substeps,Ny,Nx,window", [
    (10, 32, 48, None),             # n_sub 7: one launch; a plane smaller than a tile
    (30, 32, 48, None),             # the f64 oracle's 48 x 32 with halo 22
    (30, 53, 37, (64, 8, 6)),       # the float32 plan (11 + 10), a shape no tile divides
    (50, 19, 41, None),             # n_sub 36: six launches of 6
    (4, 70, 11, (64, 8, 6)),        # a window wider than the plane: several seams in it
])
def test_tiled_replay_matches_plain(wrap, substeps, Ny, Nx, window):
    w = averaging_weights(substeps)[1]
    n_sub = len(w)
    H = n_sub + 1
    static, eta, U, V, GU, GV = _inputs(Ny, Nx, H, seed=substeps + Nx)
    weights = torch.as_tensor(w)
    dtau = torch.tensor(0.01, dtype=torch.float64)
    args = (static, eta, U, V, GU, GV, dtau, weights, Nx, H, wrap)
    plan = (barotropic.launch_plan(*eta.shape, n_sub, torch.float64) if window is None
            else barotropic._plan(*eta.shape, n_sub, window, 11, 8))
    inputs = [a.clone() for a in (static, eta, U, V, GU, GV)]
    got = replay(*args, plan)
    want = barotropic.barotropic_substeps_plain(*args)
    for a, a0 in zip((static, eta, U, V, GU, GV), inputs):
        assert torch.equal(a, a0)
    # valid: n_sub cells from the array's edge (x is periodic under the wrap)
    I = (slice(n_sub, -n_sub), slice(None) if wrap else slice(n_sub, -n_sub))
    for g, ww in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - ww)[I].abs().max() / ww[I].abs().max()) <= 1e-12
    if wrap:  # each halo column is the interior column it copies, bitwise
        assert torch.equal(got[..., :H], got[..., Nx:Nx + H])
        assert torch.equal(got[..., H + Nx:], got[..., H:2 * H])


@pytest.mark.parametrize("wrap", [False, True])
def test_tiled_replay_independent_of_the_plan(wrap):
    """Two windows, two rings (k = 7 and k = 3) and so two tile grids give the same
    bits on the valid region: the sums run in substep order whatever the plan."""
    n_sub, Ny, Nx = 21, 41, 59
    H = n_sub + 1
    static, eta, U, V, GU, GV = _inputs(Ny, Nx, H, seed=5)
    args = (static, eta, U, V, GU, GV, torch.tensor(0.01, dtype=torch.float64),
            torch.as_tensor(averaging_weights(30)[1]), Nx, H, wrap)
    a = replay(*args, barotropic.launch_plan(*eta.shape, n_sub, torch.float64))
    b = replay(*args, barotropic._plan(*eta.shape, n_sub, (64, 8, 6), 3, 8))
    I = (slice(n_sub, -n_sub), slice(None) if wrap else slice(n_sub, -n_sub))
    assert torch.equal(a[(slice(None),) + I], b[(slice(None),) + I])
