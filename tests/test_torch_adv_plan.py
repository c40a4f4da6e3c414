"""The tracer kernel's launch plan (``kernels/tracer_adv.py:launch_plan``) on the CPU.

The plan is checked directly (tiles that cover the plane and none outside it, the
window one ``REACH`` ring wider than the tile, shared memory within the H100's 227 KB
per block at both dtypes), and the tile algorithm of ``csrc/tracer_adv.cu`` is
replayed here in PyTorch at float64, tile by tile: in layered mode the metric planes
at the tile's faces once per CTA, per layer u and v at the faces, IV and the κ_h
planes once for every tracer block, then per tracer plane c over the window (zero
outside the array), each x face and each y face reconstructed once through the
zero-dividend guard, the cells' divergence from the stored fluxes, κ_h from the
window, ``acc`` last, and the cells within ``REACH`` of the edge written 0. The replay
follows the kernel's order of operations, so on the cells the kernel keeps it must
give the plain version's bits, write every cell exactly once, and give the same bits
under another tile. The guard itself (``weno5.cuh:div_nz``) is held bitwise against
plain division, and the replay against the JAX package's Pallas kernel in interpret
mode at float64. The layered mode's member addressing (an ensemble's members on the
grid's z index, each CTA's stacks offset once, acc at a member stride of its own) is
replayed on flat buffers against one-member replays.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu.ops.pallas_adv import (  # noqa: E402
    pack_adv_statics_layered, tracer_adv_pallas)
from orthogonalsphericalshellgrids_tpu_torch.kernels import tracer_adv  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.advection import _weno5_left  # noqa: E402

DTYPES = [torch.float32, torch.float64]
MAIN = (690, 1450)
SMEM_PER_BLOCK = 232448  # the H100's shared memory per block, bytes
SMEM_PER_SM = 233472  # and per SM, 1 KB of it reserved for each resident block
R = tracer_adv.REACH


def test_plan_of_the_main_path():
    """(690, 1450) at float32: 44 x 46 tiles of 16 x 32 cells, 22 x 38 windows, 256
    threads, within the 48 KB a block gets without opting in, in every mode."""
    plan = tracer_adv.launch_plan(*MAIN, torch.float32)
    assert (plan.tile, plan.window, plan.grid, plan.threads) == ((16, 32), (22, 38),
                                                                 (44, 46), 256)
    assert max(plan.smem_bytes.values()) <= 48 * 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [MAIN, (7, 9), (1, 1), (37, 131), (135, 171), (500, 3)])
def test_plan_tiles_cover_the_plane(dtype, shape):
    plan = tracer_adv.launch_plan(*shape, dtype)
    (TY, TX), (GY, GX), (WY, WX) = plan.tile, plan.grid, plan.window
    assert (WY, WX) == (TY + 2 * R, TX + 2 * R)
    assert GY * TY >= shape[0] and (GY - 1) * TY < shape[0]
    assert GX * TX >= shape[1] and (GX - 1) * TX < shape[1]
    # a warp's threads take neighbouring columns of one row; a thread owns whole cells
    assert TX % 32 == 0 and (TY * TX) % plan.threads == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_shared_memory(dtype):
    """Every mode fits one block's shared memory, and four CTAs an SM at float32 (the
    register budget of csrc/tracer_adv.cu:Tile); layered mode double-buffers what a
    plane and a layer copy, the P-plane column mode what a plane copies (the window
    and acc), the member mode that and u and v, and κ_h and acc each take their own
    planes."""
    plan = tracer_adv.launch_plan(*MAIN, dtype)
    sm = plan.smem_bytes
    assert len(sm) == 16 and max(sm.values()) <= SMEM_PER_BLOCK and plan.threads <= 1024
    if dtype == torch.float32:
        assert 4 * (max(sm.values()) + 1024) <= SMEM_PER_SM
    item = torch.empty((), dtype=dtype).element_size()
    window, cells, faces = 22 * 38, 16 * 32, 16 * 33 + 17 * 32
    for kappa in (False, True):
        for acc in (False, True):
            assert sm["layered", kappa, acc] > sm["column", kappa, acc]
            assert sm["layered", kappa, acc] > sm["planes", kappa, acc]
            assert (sm["planes", kappa, acc] - sm["column", kappa, acc]
                    == (window + (cells if acc else 0)) * item)
            assert sm["members", kappa, acc] - sm["planes", kappa, acc] == faces * item
            assert sm["layered", True, acc] > sm["layered", False, acc]
            assert sm["layered", kappa, True] > sm["layered", kappa, False]


# ------------------------------------------------------------------------------------
# the zero-dividend guard
# ------------------------------------------------------------------------------------

def _div_nz(n, d):
    """weno5.cuh:div_nz: a zero dividend returned as it is, else n / d."""
    return torch.where(n == 0, n, n / d)


def _weno5_left_nz(m3, m2, m1, p0, p1):
    """weno5.cuh:weno5_left<true>: ``_weno5_left`` with every division guarded."""
    q0 = _div_nz(2.0 * m3 - 7.0 * m2 + 11.0 * m1, torch.full_like(m1, 6.0))
    q1 = _div_nz(-m2 + 5.0 * m1 + 2.0 * p0, torch.full_like(m1, 6.0))
    q2 = _div_nz(2.0 * m1 + 5.0 * p0 - p1, torch.full_like(m1, 6.0))
    b0 = (13.0 / 12.0) * (m3 - 2.0 * m2 + m1) ** 2 + 0.25 * (m3 - 4.0 * m2 + 3.0 * m1) ** 2
    b1 = (13.0 / 12.0) * (m2 - 2.0 * m1 + p0) ** 2 + 0.25 * (m2 - p0) ** 2
    b2 = (13.0 / 12.0) * (m1 - 2.0 * p0 + p1) ** 2 + 0.25 * (3.0 * m1 - 4.0 * p0 + p1) ** 2
    tau = torch.abs(b0 - b2)
    a0 = 0.1 * (1.0 + _div_nz(tau, b0 + 1e-8) ** 2)
    a1 = 0.6 * (1.0 + _div_nz(tau, b1 + 1e-8) ** 2)
    a2 = 0.3 * (1.0 + _div_nz(tau, b2 + 1e-8) ** 2)
    s = a0 + a1 + a2
    return _div_nz(a0 * q0 + a1 * q1 + a2 * q2, s)


def _bits_equal(a, b):
    """Equal bit patterns (a NaN equals a NaN of the same bits, -0 differs from +0)."""
    itype = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.view(itype), b.view(itype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["zeros", "negative_zeros", "signed_zeros", "nan", "inf",
                                  "random", "sparse"])
def test_zero_dividend_guard_is_bitwise(dtype, kind):
    """The guarded reconstruction gives plain division's bits on zeros of both signs,
    NaN, inf, random data and random data with most values exactly 0 (land)."""
    r = np.random.default_rng(len(kind))
    a = r.standard_normal((5, 4096))
    if kind == "zeros":
        a[:] = 0.0
    elif kind == "negative_zeros":
        a[:] = -0.0
    elif kind == "signed_zeros":
        a = np.where(r.random(a.shape) > 0.5, 0.0, -0.0)
    elif kind == "nan":
        a[r.random(a.shape) > 0.7] = np.nan
        a[r.random(a.shape) > 0.5] = 0.0
    elif kind == "inf":
        a[r.random(a.shape) > 0.8] = np.inf
        a[r.random(a.shape) > 0.8] = -np.inf
        a[r.random(a.shape) > 0.5] = 0.0
    elif kind == "sparse":
        a[r.random(a.shape) > 0.1] = 0.0
    m = torch.as_tensor(a, dtype=dtype)
    got, want = _weno5_left_nz(*m), _weno5_left(*m)
    assert _bits_equal(got, want)
    # the guard itself, on every dividend it can meet: divisors positive or +inf
    n = m.reshape(-1)
    for d in (torch.full_like(n, 6.0), n.abs() + 1e-8, torch.full_like(n, float("inf"))):
        assert _bits_equal(_div_nz(n, d), n / d)


# ------------------------------------------------------------------------------------
# the tile algorithm
# ------------------------------------------------------------------------------------

def replay(c, u, v, static, plan, g_pack=None, dz=None, acc=None):
    """The tile algorithm of csrc/tracer_adv.cu, one CTA at a time; returns G and how
    many times each cell was written."""
    layered = g_pack is not None
    Yb, Xb = c.shape[-2:]
    if layered:
        nz = u.shape[0]
        S = static.shape[0] // nz
        c3, u3, v3 = c, u, v
        lp = static.reshape(nz, S, Yb, Xb)
        diff = S == 4
    else:  # one plane, a column stack of P planes over one (u, v) pair, or members
        members = u.dim() == 3  # member k's n planes over its own (u, v), as layers
        u3, v3 = (u, v) if members else (u[None], v[None])
        nz = u3.shape[0]
        c3 = c.reshape((-1,) + c.shape[-2:])
        lp = static[None, 4:].expand((nz,) + static[4:].shape)
        diff = static.shape[0] == 8
    n_blocks = c3.shape[0] // nz
    acc3 = None if acc is None else acc.reshape(c3.shape)
    (TY, TX), (WY, WX) = plan.tile, plan.window
    G = torch.full_like(c3, float("nan"))
    writes = torch.zeros(c3.shape, dtype=torch.int64)
    zero = torch.zeros((), dtype=c.dtype)

    def region(A, y, x, ny, nx):
        """The (ny, nx) region of plane A from cell (y, x), 0 outside the array."""
        rows, cols = y + torch.arange(ny), x + torch.arange(nx)
        inside = ((rows >= 0) & (rows < Yb))[:, None] & ((cols >= 0) & (cols < Xb))[None]
        return torch.where(inside, A[rows.clamp(0, Yb - 1)][:, cols.clamp(0, Xb - 1)], zero)

    def sel_weno(pos, s):
        def sel(a, b):
            return torch.where(pos, a, b)

        return _weno5_left_nz(sel(s[0], s[5]), sel(s[1], s[4]), sel(s[2], s[3]),
                              sel(s[3], s[2]), sel(s[4], s[1]))

    for by in range(plan.grid[0]):
        for bx in range(plan.grid[1]):
            y0, x0 = by * TY, bx * TX
            # the tile's x faces (TY x TX+1) and y faces (TY+1 x TX)
            xf = (lambda A: region(A, y0, x0, TY, TX + 1))
            yf = (lambda A: region(A, y0, x0, TY + 1, TX))
            if layered:  # the metric planes at the faces, once a CTA
                dyx, dxy = xf(g_pack[0]), yf(g_pack[1])
            ny, nx = min(TY, Yb - y0), min(TX, Xb - x0)
            jj, ii = y0 + torch.arange(ny), x0 + torch.arange(nx)
            edge = ((jj < R) | (jj >= Yb - R))[:, None] | ((ii < R) | (ii >= Xb - R))[None]
            for k in range(nz):
                # IV and the κ_h planes at the cells (k + 1 and k + X for K_u, K_v)
                cell = (lambda A, dr=0, dc=0: region(A, y0 + dr, x0 + dc, TY, TX))
                iv = cell(lp[k, 0])
                if diff:
                    ku0, ku1 = cell(lp[k, 1]), cell(lp[k, 1], 0, 1)
                    kv0, kv1 = cell(lp[k, 2]), cell(lp[k, 2], 1, 0)
                    kk = cell(lp[k, 3])
                if layered:
                    ux, vy, h_x, h_y, len_x, len_y = xf(u3[k]), yf(v3[k]), dz[k], dz[k], dyx, dxy
                else:
                    ux, vy = xf(u3[k]), yf(v3[k])
                    h_x, len_x = xf(static[0]), xf(static[1])
                    h_y, len_y = yf(static[2]), yf(static[3])
                for t in range(n_blocks):
                    plane = k * n_blocks + t if not layered and members else t * nz + k
                    sc = region(c3[plane], y0 - R, x0 - R, WY, WX)
                    # x face lx of row ly: window row ly+3, columns lx..lx+5
                    sx = [sc[R:R + TY, d:d + TX + 1] for d in range(6)]
                    fx = ux * h_x * len_x * sel_weno(ux > 0, sx)
                    # y face ly of column lx: window rows ly..ly+5, column lx+3
                    sy = [sc[d:d + TY + 1, R:R + TX] for d in range(6)]
                    fy = vy * h_y * len_y * sel_weno(vy > 0, sy)
                    gx = fx[:, 1:] - fx[:, :-1]
                    gy = fy[1:] - fy[:-1]
                    out = -(gx + gy) * iv
                    if diff:
                        cc = sc[R:R + TY, R:R + TX]
                        gx0 = (cc - sc[R:R + TY, R - 1:R - 1 + TX]) * ku0
                        gx1 = (sc[R:R + TY, R + 1:R + 1 + TX] - cc) * ku1
                        gy0 = (cc - sc[R - 1:R - 1 + TY, R:R + TX]) * kv0
                        gy1 = (sc[R + 1:R + 1 + TY, R:R + TX] - cc) * kv1
                        out = out + ((gx1 - gx0) + (gy1 - gy0)) * kk
                    if acc3 is not None:
                        out = out + cell(acc3[plane])
                    G[plane, y0:y0 + ny, x0:x0 + nx] = torch.where(edge, zero, out[:ny, :nx])
                    writes[plane, y0:y0 + ny, x0:x0 + nx] += 1
    return (G.reshape(c.shape), writes.reshape(c.shape))


def _inputs(mode, n_tr, kappa, Yb, Xb, seed, nz=3):
    """(args, acc) of one tracer call at float64: column mode with the 5- or 8-plane
    pack (``planes``: a stack of ``n_tr`` tracer planes, some rows exactly 0;
    ``members``: ``nz`` members of ``n_tr`` planes each over their own u and v), or
    layered mode over masked velocities with S = 1 or 4; the κ_h term and acc drawn
    at 1e-1 to 1 of the tendency."""
    r = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64)

    if mode == "column":
        c, u, v = r.standard_normal((3, Yb, Xb))
        st = 1.0 + r.random((8 if kappa else 5, Yb, Xb))
        if kappa:
            st[7] *= 0.1
        args = (t(c), t(u), t(v), t(st))
        shape = (Yb, Xb)
    elif mode == "planes":
        u, v = r.standard_normal((2, Yb, Xb))
        c = r.standard_normal((n_tr, Yb, Xb))
        c[1:, : Yb // 3] = 0.0
        st = 1.0 + r.random((8 if kappa else 5, Yb, Xb))
        if kappa:
            st[7] *= 0.1
        args = (t(c), t(u), t(v), t(st))
        shape = c.shape
    elif mode == "members":
        u, v = r.standard_normal((2, nz, Yb, Xb))
        c = r.standard_normal((nz, n_tr, Yb, Xb) if n_tr > 1 else (nz, Yb, Xb))
        c[1:, ..., : Yb // 3, :] = 0.0
        st = 1.0 + r.random((8 if kappa else 5, Yb, Xb))
        if kappa:
            st[7] *= 0.1
        args = (t(c), t(u), t(v), t(st))
        shape = c.shape
    else:
        mask = (r.random((nz, Yb, Xb)) > 0.2).astype(np.float64)
        u = r.standard_normal((nz, Yb, Xb)) * mask
        v = r.standard_normal((nz, Yb, Xb)) * mask
        c = r.standard_normal((n_tr * nz, Yb, Xb))
        c[:, : Yb // 3] = 0.0  # exact zeros, as on land and in the front's tracer
        S = 4 if kappa else 1
        pack = ((0.5 + r.random((nz, S, Yb, Xb))) * mask[:, None]).reshape(nz * S, Yb, Xb)
        g = 0.5 + r.random((2, Yb, Xb))
        dz = np.array([50.0, 120.0, 300.0][:nz])
        args = (t(c), t(u), t(v), t(pack), t(g), t(dz))
        shape = c.shape
    return args, t(0.5 * r.standard_normal(shape))


MODES = [("column", 1, False), ("column", 1, True), ("planes", 3, False),
         ("planes", 2, True), ("members", 1, False), ("members", 2, True),
         ("layered", 1, False), ("layered", 2, False), ("layered", 1, True),
         ("layered", 2, True)]


@pytest.mark.parametrize("mode,n_tr,kappa", MODES)
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("Yb,Xb", [(7, 9), (19, 40), (37, 131), (135, 171)])
def test_tiled_replay_matches_plain(mode, n_tr, kappa, with_acc, Yb, Xb):
    """Planes smaller than one tile and planes no tile divides, in every mode, with and
    without acc: every cell written once, the REACH cells 0, and the plain version's
    bits on every other cell."""
    args, acc = _inputs(mode, n_tr, kappa, Yb, Xb, seed=Yb + Xb + n_tr + kappa)
    acc = acc if with_acc else None
    kept = [a.clone() for a in args]
    plan = tracer_adv.launch_plan(Yb, Xb, torch.float64)
    G, writes = replay(*args[:4], plan, *args[4:], acc=acc)
    want = tracer_adv.tracer_adv_plain(*args, acc=acc)
    assert all(torch.equal(a, b) for a, b in zip(args, kept))
    assert (writes == 1).all()
    I = (Ellipsis, slice(R, -R), slice(R, -R))
    assert torch.isfinite(G).all()
    assert torch.equal(G[I], want[I])
    edge = torch.ones(G.shape[-2:], dtype=torch.bool)
    edge[R:-R, R:-R] = False
    assert (G[..., edge] == 0).all()


@pytest.mark.parametrize("mode,n_tr,kappa", [("column", 1, True), ("planes", 3, True),
                                           ("members", 2, True), ("layered", 2, True)])
def test_tiled_replay_independent_of_the_tile(mode, n_tr, kappa):
    """Two tiles (the float64 one and 8 x 64, so other tile edges and other windows)
    give the same bits everywhere: each face is reconstructed from the same cells."""
    args, acc = _inputs(mode, n_tr, kappa, 41, 97, seed=5)
    a = replay(*args[:4], tracer_adv.launch_plan(41, 97, torch.float64), *args[4:], acc=acc)
    b = replay(*args[:4], tracer_adv._plan(41, 97, (8, 64), 8), *args[4:], acc=acc)
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("n_tr", [2, 3])
@pytest.mark.parametrize("kappa", [False, True])
def test_tiled_replay_planes_are_one_plane_launches(n_tr, kappa):
    """Plane p of a P-plane column launch is the one-plane launch on plane p, bit for
    bit, with acc and without (the kernel's hard limit: each plane's arithmetic is the
    one-plane launch's)."""
    args, acc = _inputs("planes", n_tr, kappa, 41, 97, seed=11 + n_tr)
    c, u, v, st = args
    plan = tracer_adv.launch_plan(41, 97, torch.float64)
    for a in (None, acc):
        G = replay(c, u, v, st, plan, acc=a)[0]
        for p in range(n_tr):
            one = replay(c[p], u, v, st, plan, acc=None if a is None else a[p])[0]
            assert torch.equal(G[p], one)


@pytest.mark.parametrize("n_tr", [1, 2])
@pytest.mark.parametrize("kappa", [False, True])
def test_tiled_replay_members_are_one_plane_launches(n_tr, kappa):
    """Plane t of member b of a member launch is the one-plane launch on that plane
    over member b's u and v, bit for bit, with acc and without."""
    args, acc = _inputs("members", n_tr, kappa, 41, 97, seed=13 + n_tr + 2 * kappa)
    c, u, v, st = args
    B = u.shape[0]
    plan = tracer_adv.launch_plan(41, 97, torch.float64)
    for a in (None, acc):
        G = replay(c, u, v, st, plan, acc=a)[0].reshape(B, n_tr, 41, 97)
        c4 = c.reshape(B, n_tr, 41, 97)
        a4 = None if a is None else a.reshape(B, n_tr, 41, 97)
        for b in range(B):
            for p in range(n_tr):
                one = replay(c4[b, p], u[b], v[b], st, plan,
                             acc=None if a4 is None else a4[b, p])[0]
                assert torch.equal(G[b, p], one), (b, p)


def test_tiled_replay_matches_pallas():
    """The replay against the JAX package's Pallas kernel in interpret mode at
    float64 (layered, T and S with κ_h and acc: the gyre's call), rtol 1e-12 of the
    field's maximum on the cells both keep (the JAX kernel's reach is 4)."""
    args, acc = _inputs("layered", 2, True, 44, 60, seed=3)
    c, u, v, pack, g, dz = args
    nz = u.shape[0]
    planes = pack.reshape(nz, 4, 44, 60).transpose(0, 1).numpy()
    jpack = pack_adv_statics_layered(*(jnp.asarray(p) for p in planes))
    assert np.array_equal(np.asarray(jpack), pack.numpy())
    want = np.asarray(tracer_adv_pallas(
        jnp.asarray(c.numpy()), jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
        statics_packed=jpack, g_pack=jnp.asarray(g.numpy()), dz=tuple(dz.tolist()),
        acc=jnp.asarray(acc.numpy()), interpret=True))
    got = replay(c, u, v, pack, tracer_adv.launch_plan(44, 60, torch.float64), g, dz,
                 acc=acc)[0].numpy()
    I = (Ellipsis, slice(4, -4), slice(4, -4))
    assert np.abs(got[I] - want[I]).max() <= 1e-12 * np.abs(want[I]).max()


def replay_layered_members(c, u, v, pack, plan, g, dz, acc=None):
    """The layered mode's member addressing on flat buffers: CTA z = m reads member
    m's c at m·n_planes·P, its u and v at m·Nz·P and its acc at m·acc.stride(0), and
    writes its G at m·n_planes·P (csrc/tracer_adv.cu), each member replayed with
    ``replay``; returns G as a (B, n_planes, Yb, Xb) stack and the writes of every
    flat cell of G."""
    B, nz, Yb, Xb = u.shape
    P, n_planes = Yb * Xb, c.shape[1]
    fc, fu, fv = c.reshape(-1), u.reshape(-1), v.reshape(-1)
    if acc is not None:  # acc's whole storage, flat, and member 0's offset in it
        fa = acc.as_strided((acc.untyped_storage().nbytes() // acc.element_size(),), (1,), 0)
    G = torch.full((B * n_planes * P,), float("nan"), dtype=c.dtype)
    writes = torch.zeros(G.shape, dtype=torch.int64)
    for m in range(B):
        oc, ov = m * n_planes * P, m * nz * P

        def at(buf, off, planes):
            return buf[off:off + planes * P].view(planes, Yb, Xb)

        a = None
        if acc is not None:
            a = at(fa, acc.storage_offset() + m * acc.stride(0), n_planes)
        g_m, w = replay(at(fc, oc, n_planes), at(fu, ov, nz), at(fv, ov, nz), pack, plan, g,
                        dz, acc=a)
        G[oc:oc + n_planes * P] = g_m.reshape(-1)
        writes[oc:oc + n_planes * P] += w.reshape(-1)
    return G.view(c.shape), writes


@pytest.mark.parametrize("kappa", [False, True])
@pytest.mark.parametrize("acc_kind", [None, "view"])
def test_tiled_replay_layered_members_are_one_member_launches(kappa, acc_kind):
    """Three layered members of two tracers (the gyre's T and S) in one launch, acc
    absent or a view of a larger stack (the c block of a dGc that also holds b, a
    member stride of its own): every cell written once, each member bitwise its
    one-member launch, and the plain version's member broadcast on the kept cells."""
    B, n_tr, Yb, Xb = 3, 2, 41, 97
    sets = [_inputs("layered", n_tr, kappa, Yb, Xb, seed=50 + m) for m in range(B)]
    (_, _, _, pack, g, dz), _ = sets[0]
    c, u, v = (torch.stack([s[0][i] for s in sets]) for i in range(3))
    acc = None
    if acc_kind == "view":
        big = torch.stack([torch.cat([s[1], s[1][:3]]) for s in sets])
        acc = big[:, :c.shape[1]]
        assert not acc.is_contiguous()
    plan = tracer_adv.launch_plan(Yb, Xb, torch.float64)
    G, writes = replay_layered_members(c, u, v, pack, plan, g, dz, acc=acc)
    assert (writes == 1).all()
    want = tracer_adv.tracer_adv_plain(c, u, v, pack, g, dz, acc=acc)
    I = (Ellipsis, slice(R, -R), slice(R, -R))
    assert torch.equal(G[I], want[I])
    for m in range(B):
        one = replay(c[m], u[m], v[m], pack, plan, g, dz,
                     acc=None if acc is None else acc[m])[0]
        assert torch.equal(G[m], one), m
