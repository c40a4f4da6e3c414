"""The momentum kernel's launch plan (``kernels/momentum.py:launch_plan``) on the CPU.

The plan is checked directly (tiles that cover the plane and none outside it, the
window one ``REACH`` ring wider than the tile, shared memory within the H100's 227 KB
per block), and the tile algorithm of ``csrc/momentum.cu`` is replayed here in
PyTorch at float64, tile by tile: each CTA's windows of the metric planes, loaded
once and zero outside the array, serve every layer; per layer the windows of u and v,
q = ζ + f over the window less its first row and column, KE over the tile and a ring
of one cell, then every cell of the tile, with the closure pack, ``acc`` and
``mask_out`` read at the cell and the cells within ``REACH`` of the edge written 0.
The replay follows the kernel's order of operations, so on the cells the kernel
keeps it must give the plain version's bits, write every cell exactly once, and give
the same bits under another tile.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch.kernels import momentum  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.advection import _weno5_left  # noqa: E402

DTYPES = [torch.float32, torch.float64]
MAIN = (690, 1450)
SMEM_PER_BLOCK = 232448  # the H100's shared memory per block, bytes
R = momentum.REACH


def test_plan_of_the_main_path():
    """(690, 1450) at float32: 87 x 23 tiles of 8 x 64 cells, 14 x 70 windows, 256
    threads, within the 48 KB a block gets without opting in."""
    plan = momentum.launch_plan(*MAIN, torch.float32)
    assert (plan.tile, plan.window, plan.grid, plan.threads) == ((8, 64), (14, 70),
                                                                 (87, 23), 256)
    assert plan.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [MAIN, (44, 60), (7, 7), (1, 1), (37, 45), (61, 97),
                                   (500, 3)])
def test_plan_tiles_cover_the_plane(dtype, shape):
    plan = momentum.launch_plan(*shape, dtype)
    (TY, TX), (GY, GX), (WY, WX) = plan.tile, plan.grid, plan.window
    assert (WY, WX) == (TY + 2 * R, TX + 2 * R)
    # the tiles cover every cell, and no tile lies wholly outside the plane
    assert GY * TY >= shape[0] and (GY - 1) * TY < shape[0]
    assert GX * TX >= shape[1] and (GX - 1) * TX < shape[1]
    # a warp's threads take neighbouring columns of one row
    assert TX % 32 == 0 and (TY * TX) % plan.threads == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_shared_memory(dtype):
    plan = momentum.launch_plan(*MAIN, dtype)
    assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.threads <= 1024


def _weno_selected(pos, cm3, cm2, cm1, c0, cp1, cp2):
    def sel(a, b):
        return torch.where(pos, a, b)

    return _weno5_left(sel(cm3, cp2), sel(cm2, cp1), sel(cm1, c0), sel(c0, cm1),
                       sel(cp1, cm2))


def replay(u, v, static, plan, has_mask=True, lay=None, has_lap=False, has_drag=False,
           acc=None, mask_out=None):
    """The tile algorithm of csrc/momentum.cu, one CTA at a time; returns (Gu, Gv)
    and how many times each cell was written."""
    one = u.dim() == 2
    u3, v3 = (u[None], v[None]) if one else (u, v)
    nz, Yb, Xb = u3.shape
    (TY, TX), (WY, WX) = plan.tile, plan.window
    L = 6 * has_lap + 2 * has_drag
    lay4 = lay.reshape(nz, L, Yb, Xb) if L else None
    Gu, Gv = torch.full_like(u3, float("nan")), torch.full_like(v3, float("nan"))
    writes = torch.zeros(u3.shape, dtype=torch.int64)

    def window(A, y, x, ny, nx):
        """The (ny, nx) region of plane A from cell (y, x), 0 outside the array."""
        rows, cols = y + torch.arange(ny), x + torch.arange(nx)
        inside = ((rows >= 0) & (rows < Yb))[:, None] & ((cols >= 0) & (cols < Xb))[None]
        return torch.where(inside, A[rows.clamp(0, Yb - 1)][:, cols.clamp(0, Xb - 1)],
                           torch.zeros((), dtype=A.dtype))

    for by in range(plan.grid[0]):
        for bx in range(plan.grid[1]):
            y0, x0 = by * TY, bx * TX

            def win(A):
                return window(A, y0 - R, x0 - R, WY, WX)

            def cell(A):
                """A read at the tile's cells and their ring of one cell (the kernel's
                reads at k, k +- 1, k +- X of a plane in global memory)."""
                return window(A, y0 - 1, x0 - 1, TY + 2, TX + 2)

            # the metric planes, once per CTA
            dy_cf, dx_fc, inv_az, f_ff, dx_cf, inv_dx, dy_fc, inv_dy = (
                win(static[i]) for i in range(8))

            def t(A, dr=0, dc=0):
                """Window array A at the tile's cells shifted by (dr, dc)."""
                return A[R + dr:R + TY + dr, R + dc:R + TX + dc]

            def c(A, dr=0, dc=0):
                return A[1 + dr:1 + TY + dr, 1 + dc:1 + TX + dc]

            for k in range(nz):
                su, sv = win(u3[k]), win(v3[k])
                # q at window rows and columns 1.. (sq[r-1, c-1])
                dvx = dy_cf[1:, 1:] * sv[1:, 1:] - dy_cf[1:, :-1] * sv[1:, :-1]
                duy = dx_fc[1:, 1:] * su[1:, 1:] - dx_fc[:-1, 1:] * su[:-1, 1:]
                sq = (dvx - duy) * inv_az[1:, 1:] + f_ff[1:, 1:]
                # KE at window rows 2..TY+2 and columns 2..TX+2 (ske[r-2, c-2])
                r0, r1, c0, c1 = slice(2, TY + 3), slice(3, TY + 4), slice(2, TX + 3), \
                    slice(3, TX + 4)
                ske = 0.5 * (0.5 * (su[r0, c0] * su[r0, c0] + su[r0, c1] * su[r0, c1])
                             + 0.5 * (sv[r0, c0] * sv[r0, c0] + sv[r1, c0] * sv[r1, c0]))

                def q(dr, dc):
                    return sq[R - 1 + dr:R - 1 + TY + dr, R - 1 + dc:R - 1 + TX + dc]

                def ke(dr, dc):
                    return ske[R - 2 + dr:R - 2 + TY + dr, R - 2 + dc:R - 2 + TX + dc]

                iy0 = 0.5 * (t(dx_cf) * t(sv) + t(dx_cf, 1) * t(sv, 1))
                iy1 = 0.5 * (t(dx_cf, 0, -1) * t(sv, 0, -1) + t(dx_cf, 1, -1) * t(sv, 1, -1))
                v_hat = 0.5 * (iy0 + iy1) * t(inv_dx)
                ix0 = 0.5 * (t(dy_fc) * t(su) + t(dy_fc, 0, 1) * t(su, 0, 1))
                ix1 = 0.5 * (t(dy_fc, -1) * t(su, -1) + t(dy_fc, -1, 1) * t(su, -1, 1))
                u_hat = 0.5 * (ix0 + ix1) * t(inv_dy)
                q_at_u = _weno_selected(v_hat > 0, *(q(d, 0) for d in range(-2, 4)))
                q_at_v = _weno_selected(u_hat > 0, *(q(0, d) for d in range(-2, 4)))
                gu = q_at_u * v_hat - (ke(0, 0) - ke(0, -1)) * t(inv_dx)
                gv = -q_at_v * u_hat - (ke(0, 0) - ke(-1, 0)) * t(inv_dy)
                if has_mask:
                    gu = gu * c(cell(static[8]))
                    gv = gv * c(cell(static[9]))
                if has_lap:
                    lu_c, lu_f, lu_s, lv_f, lv_c, lv_s = (cell(p) for p in lay4[k, :6])
                    gxu0 = (t(su, 0, 1) - t(su)) * c(lu_c)
                    gxu1 = (t(su) - t(su, 0, -1)) * c(lu_c, 0, -1)
                    gyu0 = (t(su) - t(su, -1)) * c(lu_f)
                    gyu1 = (t(su, 1) - t(su)) * c(lu_f, 1)
                    gu = gu + ((gxu0 - gxu1) + (gyu1 - gyu0)) * c(lu_s)
                    gxv0 = (t(sv) - t(sv, 0, -1)) * c(lv_f)
                    gxv1 = (t(sv, 0, 1) - t(sv)) * c(lv_f, 0, 1)
                    gyv0 = (t(sv, 1) - t(sv)) * c(lv_c)
                    gyv1 = (t(sv) - t(sv, -1)) * c(lv_c, -1)
                    gv = gv + ((gxv1 - gxv0) + (gyv0 - gyv1)) * c(lv_s)
                if has_drag:
                    dr_u, dr_v = (cell(p) for p in lay4[k, -2:])
                    vu = 0.5 * (0.5 * (t(sv) + t(sv, 1)) + 0.5 * (t(sv, 0, -1) + t(sv, 1, -1)))
                    sp_u = torch.sqrt(t(su) * t(su) + vu * vu)
                    uv = 0.5 * (0.5 * (t(su) + t(su, 0, 1)) + 0.5 * (t(su, -1) + t(su, -1, 1)))
                    sp_v = torch.sqrt(t(sv) * t(sv) + uv * uv)
                    gu = gu - c(dr_u) * sp_u * t(su)
                    gv = gv - c(dr_v) * sp_v * t(sv)
                if acc is not None:
                    gu = gu + c(cell(acc[0][k] if not one else acc[0]))
                    gv = gv + c(cell(acc[1][k] if not one else acc[1]))
                if mask_out is not None:
                    gu = gu * c(cell(mask_out[0][k] if not one else mask_out[0]))
                    gv = gv * c(cell(mask_out[1][k] if not one else mask_out[1]))
                # the tile clipped at the array's edge; REACH cells written 0
                ny, nx = min(TY, Yb - y0), min(TX, Xb - x0)
                jj = y0 + torch.arange(ny)
                ii = x0 + torch.arange(nx)
                edge = ((jj < R) | (jj >= Yb - R))[:, None] | ((ii < R) | (ii >= Xb - R))[None]
                zero = torch.zeros((), dtype=u.dtype)
                Gu[k, y0:y0 + ny, x0:x0 + nx] = torch.where(edge, zero, gu[:ny, :nx])
                Gv[k, y0:y0 + ny, x0:x0 + nx] = torch.where(edge, zero, gv[:ny, :nx])
                writes[k, y0:y0 + ny, x0:x0 + nx] += 1
    return (Gu[0], Gv[0], writes[0]) if one else (Gu, Gv, writes)


def _inputs(nz, Yb, Xb, mode, seed):
    """Random velocities and metric planes (f_ff ~ 0.1 N(0, 1)); with ``mode`` the
    masks, closure pack and operands of one of the three uses of the kernel."""
    r = np.random.default_rng(seed)
    shape = (Yb, Xb) if nz == 0 else (nz, Yb, Xb)
    u, v = r.standard_normal((2,) + shape)
    static = 1.0 + r.random((10 if nz == 0 else 8, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))
    kw = dict(has_mask=nz == 0)
    if nz == 0:
        static[8:] = r.random((2, Yb, Xb)) > 0.15
    if mode in ("operands", "closures"):
        kw["acc"] = tuple(torch.as_tensor(0.5 * r.standard_normal(shape)) for _ in range(2))
        kw["mask_out"] = tuple(torch.as_tensor((r.random(shape) > 0.2).astype(np.float64))
                               for _ in range(2))
    if mode == "closures":
        lay = 0.5 + r.random((max(nz, 1), 8, Yb, Xb))
        lay[:, 6:] *= 0.1
        kw.update(lay=torch.as_tensor(lay.reshape(-1, Yb, Xb)), has_lap=True, has_drag=True)
    return torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(static), kw


CASES = [(0, "plain"), (0, "closures"), (3, "plain"), (3, "operands"), (3, "closures")]


@pytest.mark.parametrize("nz,mode", CASES)
@pytest.mark.parametrize("Yb,Xb", [(7, 7), (12, 20), (37, 45), (61, 97)])
def test_tiled_replay_matches_plain(nz, mode, Yb, Xb):
    """Planes smaller than one tile and planes no tile divides, one masked layer
    (nz = 0) or three: every cell written once, the REACH cells 0, and the plain
    version's bits on every other cell."""
    u, v, static, kw = _inputs(nz, Yb, Xb, mode, seed=Yb + Xb + nz)
    inputs = [a.clone() for a in (u, v, static)]
    plan = momentum.launch_plan(Yb, Xb, torch.float64)
    Gu, Gv, writes = replay(u, v, static, plan, **kw)
    want = momentum.momentum_plain(u, v, static, **kw)
    assert all(torch.equal(a, b) for a, b in zip((u, v, static), inputs))
    assert (writes == 1).all()
    I = (Ellipsis, slice(R, -R), slice(R, -R))
    for got, w in zip((Gu, Gv), want):
        assert torch.isfinite(got).all()
        assert torch.equal(got[I], w[I])
        edge = torch.ones(got.shape[-2:], dtype=torch.bool)
        edge[R:-R, R:-R] = False
        assert (got[..., edge] == 0).all()


def test_tiled_replay_independent_of_the_tile():
    """Two tiles (the float64 one and 4 x 16, so other tile edges and other windows)
    give the same bits everywhere: each cell's sums do not depend on the tiling."""
    u, v, static, kw = _inputs(3, 29, 53, "closures", seed=7)
    a = replay(u, v, static, momentum.launch_plan(29, 53, torch.float64), **kw)
    b = replay(u, v, static, momentum._plan(29, 53, (4, 16), 8), **kw)
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
