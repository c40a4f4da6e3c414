"""The vertical kernel's launch plan (``kernels/vertical.py:launch_plan``) and its masks
from the wet-layer counts, on the CPU.

The plan is checked directly (tiles that cover the plane, the window one column and
one row wider than the tile, the chunk of interfaces, shared memory within the H100's
48 KB a block gets without opting in at Nz = 50). The single-pass algorithm of
``csrc/vertical.cu`` is replayed here in PyTorch at float64, tile by tile: w over the
tile's window (the tile and one column west and one row south) summed from the floor
up a chunk of interfaces at a time, each chunk summed again from the floor; then the
layers top down, b and the pressure integral once per window point, the momentum
terms from w and p of the column and its west and south points, the tracer blocks'
fluxes from w and c of the layers above, at and below; every mask from the counts
(mc = k < n, mu = mc·mc(i−1), mv = mc·mc(j−1)), the cells within ``REACH`` of the
edge written 0. The replay follows the kernel's order of operations, so on the cells
the kernel keeps it must give the bits of ``vertical_plain`` on the mask pack of the
same counts, write every cell once, and give the same bits under another chunk and
tile. The counts are pinned against the JAX model's ``vert_pack`` and the count
route against the JAX package's Pallas kernel in interpret mode, at float64.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
for p in (ROOT, TESTS):
    if p not in sys.path:
        sys.path.insert(0, p)

from test_torch_layered import CONFIGS, _jax_model, _torch_model  # noqa: E402

from orthogonalsphericalshellgrids_tpu.ops.pallas_vert import (  # noqa: E402
    pack_vert_statics, vertical_pallas)
from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import vertical  # noqa: E402

DTYPES = [torch.float32, torch.float64]
MAIN = (690, 1450)
R = vertical.REACH
EOS = (9.81, 1.67e-4, 7.8e-4, 10.0, 35.0)
IAZ, IDX, IDY, DYFC, DXCF = range(5)


def test_plan_of_the_main_path():
    """(10, 690, 1450) at float32: 87 x 46 tiles of 8 x 32 columns, 9 x 33 windows,
    one chunk of the 9 interfaces, 256 threads."""
    plan = vertical.launch_plan(10, *MAIN, torch.float32)
    assert (plan.tile, plan.window, plan.grid, plan.threads, plan.chunk) == (
        (8, 32), (9, 33), (87, 46), 256, 9)
    assert plan.smem_bytes == (9 + 1) * 9 * 33 * 4 + 9 * 33 * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nz", [1, 2, 10, 17, 33, 50, 200])
def test_plan_chunks_and_shared_memory(dtype, nz):
    plan = vertical.launch_plan(nz, *MAIN, dtype)
    (TY, TX), (WY, WX) = plan.tile, plan.window
    assert (WY, WX) == (TY + 1, TX + 1) and TY * TX == plan.threads
    assert 1 <= plan.chunk <= vertical.CHUNK[dtype]
    assert plan.chunk == min(max(nz - 1, 1), vertical.CHUNK[dtype])
    assert plan.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("shape", [MAIN, (7, 9), (1, 1), (37, 131), (500, 3)])
def test_plan_tiles_cover_the_plane(shape):
    plan = vertical.launch_plan(4, *shape, torch.float64)
    (TY, TX), (GY, GX) = plan.tile, plan.grid
    assert GY * TY >= shape[0] and (GY - 1) * TY < shape[0]
    assert GX * TX >= shape[1] and (GX - 1) * TX < shape[1]


# ------------------------------------------------------------------------------------
# the counts
# ------------------------------------------------------------------------------------

def test_wet_counts_refuse_what_they_cannot_represent():
    wet = np.ones((3, 4, 5), dtype=bool)
    wet[:, 0, 0] = False
    wet[2, 1, 1] = False
    n = vertical.wet_counts(wet)
    assert n.dtype == torch.int32 and n[0, 0] == 0 and n[1, 1] == 2 and n[2, 2] == 3
    wet[0, 3, 3] = False  # a dry layer above a wet one
    with pytest.raises(ValueError):
        vertical.wet_counts(wet)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_counts_rebuild_the_jax_models_vert_pack(config):
    """The model's counts give the JAX model's vertical mask pack bitwise (S = 3 with
    an explicit ν_v, else 1), and all three of its masks."""
    jm, _ = _jax_model(CONFIGS[config])
    tm, _ = _torch_model(CONFIGS[config])
    want = np.asarray(jm.vert_pack)
    nz = tm.nz
    S = want.shape[0] // nz
    assert S == (3 if tm.nu_v > 0.0 and not tm.vert_impl else 1)
    assert torch.equal(tm.n_wet, vertical.wet_counts(np.asarray(jm.mask_c3)))
    assert len(torch.unique(tm.n_wet)) >= 3  # land, shelf and deep columns
    got = vertical.wet_pack(tm.n_wet, nz, S, torch.float64).numpy()
    np.testing.assert_array_equal(got, want)
    full = vertical.wet_pack(tm.n_wet, nz, 3, torch.float64).reshape(nz, 3, *want.shape[1:])
    for i, name in enumerate(("mask_c3", "mask_u3", "mask_v3")):
        np.testing.assert_array_equal(full[:, i].numpy(), np.asarray(getattr(jm, name)))


# ------------------------------------------------------------------------------------
# the single-pass algorithm
# ------------------------------------------------------------------------------------

def replay(u, v, c, b, n_wet, g, coef, plan, mode="none", eos=EOS, it_T=-1, it_S=-1,
           viscous=False, diffusive=False):
    """The algorithm of csrc/vertical.cu, one CTA at a time; returns (dGu, dGv, dGc)
    and how many times each output cell was written."""
    nz, Yb, Xb = u.shape
    n_c = c.shape[0] // nz
    blocks = [c[t * nz:(t + 1) * nz] for t in range(n_c)] + ([b] if b is not None else [])
    (TY, TX), (WY, WX), chunk = plan.tile, plan.window, plan.chunk
    dz, rdzc, mrdz, nudz, kapdz = coef
    g_b, alpha, beta, T0, S0 = eos
    zero = torch.zeros((), dtype=u.dtype)
    dgu, dgv = torch.full_like(u, float("nan")), torch.full_like(v, float("nan"))
    dgc = torch.full((len(blocks) * nz, Yb, Xb), float("nan"), dtype=u.dtype)
    writes = torch.zeros((2 + len(blocks), nz, Yb, Xb), dtype=torch.int64)

    def region(A, y, x, ny, nx):
        rows, cols = y + torch.arange(ny), x + torch.arange(nx)
        inside = ((rows >= 0) & (rows < Yb))[:, None] & ((cols >= 0) & (cols < Xb))[None]
        return torch.where(inside, A[rows.clamp(0, Yb - 1)][:, cols.clamp(0, Xb - 1)],
                           torch.zeros((), dtype=A.dtype))

    def m(x):
        return x.to(u.dtype)

    for by in range(plan.grid[0]):
        for bx in range(plan.grid[1]):
            y0, x0 = by * TY, bx * TX

            def win(A, dy=0, dx=0):
                """A over the window (rows y0-1.., columns x0-1..), shifted by (dy, dx)."""
                return region(A, y0 - 1 + dy, x0 - 1 + dx, WY, WX)

            rows, cols = y0 - 1 + torch.arange(WY), x0 - 1 + torch.arange(WX)
            w_ok = ((rows >= 0) & (rows < Yb - 1))[:, None] & ((cols >= 0) & (cols < Xb - 1))[None]
            n_win = win(n_wet)

            def w_chunk(klo, khi):
                iaz, dyfc, dyfc_e = win(g[IAZ]), win(g[DYFC]), win(g[DYFC], 0, 1)
                dxcf, dxcf_n = win(g[DXCF]), win(g[DXCF], 1, 0)
                acc, out = None, {}
                for k in range(nz - 1, klo - 1, -1):
                    fu, fu_e = dyfc * win(u[k]), dyfc_e * win(u[k], 0, 1)
                    fv, fv_n = dxcf * win(v[k]), dxcf_n * win(v[k], 1, 0)
                    hdiv = dz[k] * ((fu_e - fu) + (fv_n - fv)) * iaz
                    acc = hdiv if k == nz - 1 else acc + hdiv
                    if k <= khi:
                        out[k] = torch.where(w_ok, -acc, zero)
                return out

            def at(A):  # window array at the tile's columns, and their west and south
                return A[1:, 1:], A[1:, :-1], A[:-1, 1:]

            nc, nw, ns = at(n_win)
            ny, nx = min(TY, Yb - y0), min(TX, Xb - x0)
            jj, ii = y0 + torch.arange(ny), x0 + torch.arange(nx)
            keep = ((jj >= 1) & (jj < Yb - 1))[:, None] & ((ii >= 1) & (ii < Xb - 1))[None]
            cut = (slice(y0, y0 + ny), slice(x0, x0 + nx))

            def col(A):
                return region(A, y0, x0, TY, TX)

            def store(out, k, val, which):
                out[k][cut] = torch.where(keep, val[:ny, :nx], zero)
                writes[which, k % nz][cut] += 1

            sw, csum, w_t = {}, None, None
            cu_t = cv_t = fu_t = fv_t = None
            for k in range(nz):
                top, bot = k > 0, k + 1 < nz
                if bot and k % chunk == 0:
                    sw = w_chunk(k + 1, min(k + chunk, nz - 1))
                if mode != "none":
                    if mode == "tracer_b":
                        bk = win(b[k])
                    else:
                        bk = None
                        if it_T >= 0:
                            bk = alpha * (win(c[it_T * nz + k]) - T0)
                        if it_S >= 0:
                            t = beta * (win(c[it_S * nz + k]) - S0)
                            bk = -t if bk is None else bk - t
                        bk = g_b * bk * m(k < n_win)
                    bdz = dz[k] * bk
                    csum = csum + bdz if top else bdz
                    p = 0.5 * bdz - csum
                # momentum
                cu_b = cv_b = fu_b = fv_b = w_b = None
                if bot:
                    du = (col(u[k]) - col(u[k + 1])) * rdzc[k]
                    dv = (col(v[k]) - col(v[k + 1])) * rdzc[k]
                    w_b, w_w, w_s = at(sw[k + 1])
                    cu_b = 0.5 * (w_b + w_w) * du
                    cv_b = 0.5 * (w_b + w_s) * dv
                    if viscous:
                        fu_b = du * (m((k < nc) & (k < nw)) * m((k + 1 < nc) & (k + 1 < nw)))
                        fv_b = dv * (m((k < nc) & (k < ns)) * m((k + 1 < nc) & (k + 1 < ns)))
                gu = gv = torch.zeros((TY, TX), dtype=u.dtype)
                if top or bot:
                    su = (cu_t + cu_b if bot else cu_t) if top else cu_b
                    sv = (cv_t + cv_b if bot else cv_t) if top else cv_b
                    gu, gv = -0.5 * su, -0.5 * sv
                    if viscous:
                        tu = (fu_t + (-fu_b) if bot else fu_t) if top else -fu_b
                        tv = (fv_t + (-fv_b) if bot else fv_t) if top else -fv_b
                        gu = gu + nudz[k] * tu
                        gv = gv + nudz[k] * tv
                if mode != "none":
                    pc, pw, ps = at(p)
                    gu = gu - (pc - pw) * col(g[IDX])
                    gv = gv - (pc - ps) * col(g[IDY])
                store(dgu, k, gu, 0)
                store(dgv, k, gv, 1)
                # tracers
                mck = m(k < nc)
                for t, ct in enumerate(blocks):
                    ck = col(ct[k])
                    f_t = f_b = d_t = d_b = None
                    if top:
                        cm = col(ct[k - 1])
                        f_t = w_t * (0.5 * (cm + ck))
                        if diffusive:
                            d_t = (cm - ck) * rdzc[k - 1] * (m(k - 1 < nc) * mck)
                    if bot:
                        cb = col(ct[k + 1])
                        f_b = w_b * (0.5 * (ck + cb))
                        if diffusive:
                            d_b = (ck - cb) * rdzc[k] * (mck * m(k + 1 < nc))
                    G = torch.zeros((TY, TX), dtype=u.dtype)
                    if top or bot:
                        G = mrdz[k] * ((f_t + (-f_b) if bot else f_t) if top else -f_b)
                        if diffusive:
                            G = G + kapdz[k] * ((d_t + (-d_b) if bot else d_t) if top else -d_b)
                    dgc[t * nz + k][cut] = torch.where(keep, (G * mck)[:ny, :nx], zero)
                    writes[2 + t, k][cut] += 1
                cu_t, cv_t, fu_t, fv_t, w_t = cu_b, cv_b, fu_b, fv_b, w_b
    return dgu, dgv, dgc, writes


def _inputs(mode, nz, Yb, Xb, seed, mixing):
    """Float64 (u, v, c, b, n_wet, g, coef) and keywords of one call: counts drawn from
    0 to Nz a column (Nz more often), u and v masked by the masks of the counts, T and
    S about 10 and 35 for the linear EOS."""
    r = np.random.default_rng(seed)
    n_wet = torch.as_tensor(np.minimum(r.integers(0, nz + 3, (Yb, Xb)), nz).astype(np.int32))
    _, mu, mv = vertical.wet_pack(n_wet, nz, 3, torch.float64).reshape(
        nz, 3, Yb, Xb).transpose(0, 1)
    n_c = 2 if mode == "linear_eos" else 1
    c = r.standard_normal((n_c * nz, Yb, Xb))
    if mode == "linear_eos":
        c[:nz] += 10.0
        c[nz:] = 35.0 + 0.1 * c[nz:]
    dz = [50.0 * 1.07 ** k for k in range(nz)]
    dzc = [0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1)]
    t = torch.as_tensor
    args = (t(r.standard_normal((nz, Yb, Xb))) * mu, t(r.standard_normal((nz, Yb, Xb))) * mv,
            t(c), t(r.standard_normal((nz, Yb, Xb))) if mode == "tracer_b" else None, n_wet,
            t(0.5 + r.random((5, Yb, Xb))),
            t(vertical.coefficients(dz, dzc, 1e-3 if mixing else 0.0,
                                    1e-5 if mixing else 0.0)))
    kw = dict(mode=mode, eos=EOS, it_T=0 if n_c == 2 else -1, it_S=1 if n_c == 2 else -1,
              viscous=mixing, diffusive=mixing)
    return args, kw


@pytest.mark.parametrize("mode", ["none", "tracer_b", "linear_eos"])
@pytest.mark.parametrize("mixing", [False, True])
@pytest.mark.parametrize("nz,Yb,Xb", [(1, 11, 37), (4, 19, 70), (50, 13, 37)])
def test_single_pass_replay_matches_plain(mode, mixing, nz, Yb, Xb):
    """Every mode, with and without ν_v/κ_v, at Nz = 1, 4 and 50 (four chunks of w
    at float64): every cell written once, the edge 0, and the bits of
    ``vertical_plain`` on the mask pack of the same counts."""
    args, kw = _inputs(mode, nz, Yb, Xb, seed=nz + Yb + mixing, mixing=mixing)
    kept = [a.clone() for a in args if a is not None]
    plan = vertical.launch_plan(nz, Yb, Xb, torch.float64)
    assert plan.chunk == (16 if nz == 50 else max(nz - 1, 1))
    *got, writes = replay(*args, plan, **kw)
    u, v, c, b, n_wet, g, coef = args
    s_pack = vertical.wet_pack(n_wet, nz, 3 if mixing else 1, torch.float64)
    want = vertical.vertical_plain(u, v, c, b, s_pack, g, coef, **kw)
    assert all(torch.equal(a, x) for a, x in zip(kept, (a for a in args if a is not None)))
    assert (writes == 1).all()
    I = (Ellipsis, slice(R, -R), slice(R, -R))
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a[I], w[I])
        edge = torch.ones(a.shape[-2:], dtype=torch.bool)
        edge[R:-R, R:-R] = False
        assert (a[..., edge] == 0).all()
    # the wrapper's CPU route computes the same function from the same counts
    for a, w in zip(vertical.vertical(*args, **kw), want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("mode", ["tracer_b", "linear_eos"])
def test_single_pass_replay_independent_of_the_plan(mode):
    """Chunks of 3 interfaces and 4 x 16 tiles give the bits of the plan's one chunk
    of 8 x 32: each chunk of w is summed from the floor in the same order."""
    args, kw = _inputs(mode, 9, 21, 45, seed=4, mixing=True)
    a = replay(*args, vertical.launch_plan(9, 21, 45, torch.float64), **kw)
    b = replay(*args, vertical._plan(9, 21, 45, (4, 16), 3, 8), **kw)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["none", "tracer_b", "linear_eos"])
def test_count_route_matches_pallas(mode):
    """The wrapper's count route against the JAX package's Pallas kernel in interpret
    mode on the S = 3 pack of the same masks, at float64 (rtol 1e-12 of each field's
    maximum, the band of tests/test_torch_layered.py), with ν_v and κ_v; no launch on
    the CPU."""
    nz, Yb, Xb = 3, 40, 60
    args, kw = _inputs(mode, nz, Yb, Xb, seed=9, mixing=True)
    u, v, c, b, n_wet, g, coef = args
    pack = vertical.wet_pack(n_wet, nz, 3, torch.float64)
    mc, mu, mv = pack.reshape(nz, 3, Yb, Xb).transpose(0, 1).numpy()
    spack = pack_vert_statics(*(jnp.asarray(x) for x in (mc, mu, mv)))
    assert np.array_equal(np.asarray(spack), pack.numpy())
    tb = mode == "tracer_b"
    cc = torch.cat([c, b]) if tb else c
    dz = [50.0 * 1.07 ** k for k in range(nz)]
    dzc = [0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1)]
    want = vertical_pallas(
        jnp.asarray(u.numpy()), jnp.asarray(v.numpy()), jnp.asarray(cc.numpy()), spack,
        jnp.asarray(g.numpy()), dz=dz, dzc=dzc, mode=mode, g_b=EOS[0], alpha=EOS[1],
        beta=EOS[2], T0=EOS[3], S0=EOS[4], it_T=kw["it_T"], it_S=kw["it_S"],
        it_B=1 if tb else -1, nu_v=1e-3, kappa_v=1e-5, interpret=True)
    kernels.reset_launch_counts()
    got = vertical.vertical(*args, **kw)
    assert kernels.launch_counts()["vertical"] == 0
    I = (slice(None), slice(1, -1), slice(1, -1))
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(a.numpy()[I] - w[I]).max() <= 1e-12 * np.abs(w[I]).max()
