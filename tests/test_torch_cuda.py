"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here needs the card and skips elsewhere with the reason. The file imports
no jax, so it runs on a machine without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bands (``max |kernel - plain| / max |plain|`` over the valid cells; the kernels follow
the plain versions' arithmetic order and differ only where nvcc contracts a multiply
and an add into one FMA): float32 1e-5, float64 1e-12. The halo fill moves data and
multiplies by ±1, so both its modes are held bitwise.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch import kernels  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.kernels import (  # noqa: E402
    barotropic, corrector, halo_fill, momentum, tracer_adv, vertical)
from orthogonalsphericalshellgrids_tpu_torch.models import hydrostatic as TH  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.models import layered as TL  # noqa: E402
from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC, FF  # noqa: E402

torch.set_num_threads(1)

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card: the kernel has no CPU mode")

BANDS = {torch.float32: 1e-5, torch.float64: 1e-12}


def _rel_err(got, want, sl):
    got, want = got[..., sl[0], sl[1]], want[..., sl[0], sl[1]]
    return float((got - want).abs().max() / want.abs().max())


def _edge_zero(g, R):
    """All four strips of ``R`` cells at the plane's edge are 0."""
    return all(bool((strip == 0).all()) for strip in (
        g[..., :R, :], g[..., -R:, :], g[..., :R], g[..., -R:]))


def _mom_inputs(dtype, Yb=60, Xb=76, seed=0):
    r = np.random.default_rng(seed)
    u, v = r.standard_normal((2, Yb, Xb))
    static = 1.0 + r.random((10, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))                   # f_ff
    static[8:] = (r.random((2, Yb, Xb)) > 0.15).astype(np.float64)  # masks
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (u, v, static)]


def _adv_inputs(dtype, Yb=60, Xb=76, seed=3):
    r = np.random.default_rng(seed)
    c, u, v = r.standard_normal((3, Yb, Xb))
    static = 1.0 + r.random((5, Yb, Xb))
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in (c, u, v, static)]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("loc,sign", [(CC, 1), (FC, -1), (CF, -1), (FF, 1), (FC, 1)])
def test_cuda_fill_bitwise(dtype, loc, sign):
    for H in (5, 22):
        A = torch.as_tensor(np.random.default_rng(H).standard_normal(
            (3, 40 + 2 * H, 48 + 2 * H)), dtype=dtype, device="cuda")
        A0 = A.clone()
        want = halo_fill.fill_halos_plain(A.clone(), loc, sign, 48, 40, H, H)
        got = halo_fill.fill_halos(A.clone(), loc, sign, 48, 40, H, H)
        copy = halo_fill.fill_halos(A, loc, sign, 48, 40, H, H, inplace=False)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(copy, want) and torch.equal(A, A0)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_momentum(dtype):
    u, v, static = _mom_inputs(dtype)
    R = momentum.REACH
    got = momentum.momentum(u, v, static)
    for g, w in zip(got, momentum.momentum_plain(u, v, static)):
        assert _rel_err(g, w, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
        assert torch.isfinite(g).all()
        assert _edge_zero(g, R)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tracer_adv(dtype):
    c, u, v, static = _adv_inputs(dtype)
    R = tracer_adv.REACH
    got = tracer_adv.tracer_adv(c, u, v, static)
    want = tracer_adv.tracer_adv_plain(c, u, v, static)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrap", [False, True])
def test_cuda_barotropic(dtype, wrap):
    from examples.bickley_jet_torch import build

    model, _ = build(48, 40, dtype=dtype, substeps=30, device="cuda")
    ge = model.grid_ext
    ext = (ge.Ny + 2 * ge.Hy, ge.Nx + 2 * ge.Hx)
    r = np.random.default_rng(9)
    eta, U, V = (halo_fill.fill_halos_plain(
        torch.as_tensor(0.01 * r.standard_normal(ext), dtype=dtype, device="cuda"),
        loc, s, ge.Nx, ge.Ny, ge.Hx, ge.Hy) for loc, s in ((CC, 1), (FC, -1), (CF, -1)))
    GU, GV = (1e-6 * torch.ones(ext, dtype=dtype, device="cuda") for _ in range(2))
    dtau = model.fractional_dt * torch.as_tensor(120.0, dtype=dtype, device="cuda")
    args = (model.baro_pack, eta, U, V, GU, GV, dtau, model.weights, ge.Nx, ge.Hx, wrap)
    I = (slice(ge.Hy, ge.Hy + ge.Ny), slice(ge.Hx, ge.Hx + ge.Nx))
    inputs = [a.clone() for a in (eta, U, V)]
    for got, want in zip(barotropic.barotropic_substeps(*args),
                         barotropic.barotropic_substeps_plain(*args)):
        assert _rel_err(got, want, I) <= BANDS[dtype]
        assert torch.isfinite(got).all()
    for a, a0 in zip((eta, U, V), inputs):  # the kernel reads its inputs in place
        assert torch.equal(a, a0)


def _baro_inputs(Ny, Nx, H, dtype, seed):
    """Random planes on an (Ny + 2H, Nx + 2H) grid, not halo-filled; the masks are 0
    and 1 and gh_u is not 0 where mask_u is."""
    r = np.random.default_rng(seed)
    Ye, Xe = Ny + 2 * H, Nx + 2 * H
    static = 0.5 + r.random((9, Ye, Xe))
    static[7:] = static[7:] > 0.6
    planes = (static, *(0.01 * r.standard_normal((3, Ye, Xe))),
              *(1e-3 * r.standard_normal((2, Ye, Xe))))
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in planes]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("substeps,Ny,Nx", [(10, 10, 12), (24, 53, 37), (30, 53, 37),
                                            (44, 61, 97), (50, 61, 97)])
def test_cuda_barotropic_tiles(dtype, wrap, substeps, Ny, Nx):
    """The time-tiled kernel where the tiles do not fit the plane: a plane smaller than
    one tile (10 x 12 with halo 8), planes that no tile divides, and 7, 17, 21, 31 and
    36 substeps, which leave a last launch shorter than the others (17, 21 and 31 at
    float32, 17 and 31 at float64). One wrapper call; finite everywhere; inputs
    unchanged; with the wrap each halo column equals the column it copies, bitwise."""
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)

    w = averaging_weights(substeps)[1]
    n_sub, H = len(w), len(w) + 1
    planes = _baro_inputs(Ny, Nx, H, dtype, seed=substeps)
    kept = [a.clone() for a in planes]
    args = (*planes, torch.tensor(0.01, dtype=dtype, device="cuda"),
            torch.as_tensor(w, dtype=dtype, device="cuda"), Nx, H, wrap)
    kernels.reset_launch_counts()
    got = barotropic.barotropic_substeps(*args)
    assert kernels.launch_counts()["barotropic"] == 1
    want = barotropic.barotropic_substeps_plain(*args)
    # valid: n_sub cells from the array's edge (x is periodic under the wrap)
    I = (slice(n_sub, -n_sub), slice(None) if wrap else slice(n_sub, -n_sub))
    for g, ww in zip(got, want):
        assert _rel_err(g, ww, I) <= BANDS[dtype]
        assert torch.isfinite(g).all()
        if wrap:
            assert torch.equal(g[:, :H], g[:, Nx:Nx + H])
            assert torch.equal(g[:, H + Nx:], g[:, H:2 * H])
    for a, a0 in zip(planes, kept):
        assert torch.equal(a, a0)


@needs_cuda
def test_cuda_barotropic_refuses_what_it_cannot_run():
    """The entry point refuses a plan for another window, and the wrapper a wrap whose
    halo does not fit the plane; neither falls back."""
    static, eta, U, V, GU, GV = _baro_inputs(20, 30, 8, torch.float32, seed=1)
    dtau = torch.tensor(0.01, dtype=torch.float32, device="cuda")
    w = torch.full((7,), 1 / 7, dtype=torch.float32, device="cuda")
    acc = torch.empty((3, *eta.shape), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.call("osg_barotropic", torch.float32, eta.device, static.data_ptr(),
                     eta.data_ptr(), U.data_ptr(), V.data_ptr(), GU.data_ptr(),
                     GV.data_ptr(), 0, acc.data_ptr(), dtau.data_ptr(), w.data_ptr(), 7,
                     *eta.shape, 30, 8, 0, 7, 32, 48)
    with pytest.raises(ValueError, match="x-wrap"):
        barotropic.barotropic_substeps(static, eta, U, V, GU, GV, dtau, w, 29, 8, True)


@needs_cuda
def test_cuda_steps_match_cpu_float64():
    """Five float64 steps through the kernels agree with the CPU plain path."""
    from examples.bickley_jet_torch import build

    cpu_m, cpu_s = build(48, 40, dtype=torch.float64, substeps=30, device="cpu")
    gpu_m, gpu_s = build(48, 40, dtype=torch.float64, substeps=30, device="cuda")
    kernels.reset_launch_counts()
    gpu_out = TH.multi_step(gpu_m, gpu_s, 120.0, 5)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=10, halo_fill_copy=30, barotropic=5, momentum=5, tracer_adv=5)
    assert kernels.launch_counts() == want
    cpu_out = TH.multi_step(cpu_m, cpu_s, 120.0, 5)
    g = cpu_m.grid
    for name in ("u", "v", "c"):
        want = getattr(cpu_out, name)[g.interior2d]
        got = getattr(gpu_out, name).cpu()[g.interior2d]
        assert float((got - want).abs().max()) <= 1e-11 * float(want.abs().max()), name


# ----------------------------------------------------------------------------------
# the layered kernels
# ----------------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode,nz,mixing", [("none", 4, False), ("tracer_b", 4, True),
                                            ("linear_eos", 4, True), ("linear_eos", 4, False),
                                            ("tracer_b", 50, True)])
def test_cuda_vertical(dtype, mode, nz, mixing):
    r = np.random.default_rng(nz)
    Yb, Xb = 40, 52
    mc, mu, mv = (r.random((3, nz, Yb, Xb)) > 0.2).astype(np.float64)
    n_c = 2 if mode == "linear_eos" else 1
    c = r.standard_normal((n_c * nz, Yb, Xb))
    if mode == "linear_eos":
        c[:nz] += 10.0
        c[nz:] = 35.0 + 0.1 * c[nz:]
    S = 3 if mixing else 1
    sp = np.stack([mc, mu, mv][:S], axis=1).reshape(S * nz, Yb, Xb)
    dz = [50.0 * 1.05 ** k for k in range(nz)]
    dzc = [0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1)]
    coef = vertical.coefficients(dz, dzc, 1e-3 if mixing else 0.0, 1e-5 if mixing else 0.0)
    arrays = [r.standard_normal((nz, Yb, Xb)) * mu, r.standard_normal((nz, Yb, Xb)) * mv, c,
              r.standard_normal((nz, Yb, Xb)) if mode == "tracer_b" else None, sp,
              0.5 + r.random((5, Yb, Xb)), coef]
    args = [None if a is None else torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in arrays]
    kw = dict(mode=mode, eos=(9.81, 1.67e-4, 7.8e-4, 10.0, 35.0),
              it_T=0 if n_c == 2 else -1, it_S=1 if n_c == 2 else -1, viscous=mixing,
              diffusive=mixing)
    kernels.reset_launch_counts()
    got = vertical.vertical(*args, **kw)
    assert kernels.launch_counts()["vertical"] == 1
    for g, w in zip(got, vertical.vertical_plain(*args, **kw)):
        assert _rel_err(g, w, (slice(1, -1), slice(1, -1))) <= BANDS[dtype]
        assert torch.isfinite(g).all()
        assert (g[:, 0] == 0).all() and (g[:, :, -1] == 0).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_layered_momentum(dtype):
    r = np.random.default_rng(1)
    u, v = (torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in r.standard_normal((2, 3, 60, 76)))
    static = 1.0 + r.random((8, 60, 76))
    static[3] = 0.1 * r.standard_normal((60, 76))
    static = torch.as_tensor(static, dtype=dtype, device="cuda")
    R = momentum.REACH
    kernels.reset_launch_counts()
    got = momentum.momentum(u, v, static, has_mask=False)
    assert kernels.launch_counts()["momentum_layered"] == 1
    for g, w in zip(got, momentum.momentum_plain(u, v, static, has_mask=False)):
        assert _rel_err(g, w, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
        assert torch.isfinite(g).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_tr", [1, 2])
def test_cuda_layered_tracer_adv(dtype, n_tr):
    r = np.random.default_rng(n_tr)
    mask = (r.random((3, 60, 76)) > 0.2).astype(np.float64)
    arrays = (r.standard_normal((3 * n_tr, 60, 76)), r.standard_normal((3, 60, 76)) * mask,
              r.standard_normal((3, 60, 76)) * mask, mask * (0.5 + r.random((3, 60, 76))),
              0.5 + r.random((2, 60, 76)), np.array([50.0, 120.0, 300.0]))
    args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays]
    R = tracer_adv.REACH
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(*args)
    assert kernels.launch_counts()["tracer_adv_layered"] == 1
    want = tracer_adv.tracer_adv_plain(*args)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all()


@needs_cuda
def test_cuda_layered_steps_match_cpu_float64():
    """Three float64 steps of the baroclinic front through the kernels agree with the
    CPU plain path, and each step launches every layered kernel."""
    from examples.baroclinic_front_torch import build

    cpu_m, cpu_s = build(48, 32, 3, dtype=torch.float64, substeps=12, device="cpu")
    gpu_m, gpu_s = build(48, 32, 3, dtype=torch.float64, substeps=12, device="cuda")
    kernels.reset_launch_counts()
    gpu_out = TL.layered_multi_step(gpu_m, gpu_s, 120.0, 3)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=6, halo_fill_copy=21, barotropic=3, vertical=3,
                momentum_layered=3, tracer_adv_layered=6, corrector=3)
    assert kernels.launch_counts() == want
    cpu_out = TL.layered_multi_step(cpu_m, cpu_s, 120.0, 3)
    I3 = (slice(None),) + cpu_m.grid.interior2d
    for name in ("u", "v", "c", "b"):
        w = getattr(cpu_out, name)[I3]
        got = getattr(gpu_out, name).cpu()[I3]
        assert float((got - w).abs().max()) <= 1e-11 * float(w.abs().max()), name


# ----------------------------------------------------------------------------------
# the gyre's closure modes and the corrector
# ----------------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,has_lap,has_drag", [(1, True, True), (4, True, True),
                                                 (4, False, True), (50, True, True)])
def test_cuda_momentum_closures(dtype, nz, has_lap, has_drag):
    """One masked layer (nz = 1, the single-layer model) or an unmasked stack."""
    r = np.random.default_rng(nz + has_lap)
    Yb, Xb = 40, 52
    masked = nz == 1
    shape = (Yb, Xb) if masked else (nz, Yb, Xb)
    static = 1.0 + r.random((10 if masked else 8, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))
    if masked:
        static[8:] = r.random((2, Yb, Xb)) > 0.15
    L = 6 * has_lap + 2 * has_drag
    # each fused term O(1e-1..1) of G, so that the float32 band sees it
    lay = 0.5 + r.random((nz, L, Yb, Xb))
    lay[:, 6 * has_lap:] *= 0.1
    arrays = (r.standard_normal(shape), r.standard_normal(shape), static,
              lay.reshape(nz * L, Yb, Xb))
    u, v, st, lay = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays)
    kw = dict(has_mask=masked, lay=lay, has_lap=has_lap, has_drag=has_drag)
    R = momentum.REACH
    kernels.reset_launch_counts()
    got = momentum.momentum(u, v, st, **kw)
    assert kernels.launch_counts()["momentum_closures"] == 1
    for g, w in zip(got, momentum.momentum_plain(u, v, st, **kw)):
        assert _rel_err(g, w, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
        assert torch.isfinite(g).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,has_lap,has_drag,operands", [
    (1, False, False, "acc"), (1, True, True, "both"), (4, False, False, "both"),
    (4, False, False, "mask_out"), (4, True, True, "both"), (4, False, True, "acc"),
    (50, True, True, "both")])
@pytest.mark.parametrize("Yb,Xb", [(40, 52), (7, 9), (37, 131)])
def test_cuda_momentum_operands(dtype, nz, has_lap, has_drag, operands, Yb, Xb):
    """The tiled kernel with acc and/or mask_out in each mode, on planes smaller than
    a tile and planes no tile divides: within the band, finite, the REACH cells 0,
    the inputs unchanged, one launch."""
    r = np.random.default_rng(nz + 3 * has_lap + Yb)
    masked = nz == 1
    shape = (Yb, Xb) if masked else (nz, Yb, Xb)
    static = 1.0 + r.random((10 if masked else 8, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))
    if masked:
        static[8:] = r.random((2, Yb, Xb)) > 0.15
    L = 6 * has_lap + 2 * has_drag
    lay = 0.5 + r.random((nz, L, Yb, Xb))
    lay[:, 6 * has_lap:] *= 0.1

    def cu(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    u, v, st = cu(r.standard_normal(shape)), cu(r.standard_normal(shape)), cu(static)
    kw = dict(has_mask=masked, lay=cu(lay.reshape(nz * L, Yb, Xb)) if L else None,
              has_lap=has_lap, has_drag=has_drag)
    if operands in ("acc", "both"):  # O(1e-1..1) of G, so that the band sees it
        kw["acc"] = (cu(0.5 * r.standard_normal(shape)), cu(0.5 * r.standard_normal(shape)))
    if operands in ("mask_out", "both"):
        kw["mask_out"] = (cu(r.random(shape) > 0.2), cu(r.random(shape) > 0.2))
    kept = [a.clone() for a in (u, v, st)]
    R = momentum.REACH
    kernels.reset_launch_counts()
    got = momentum.momentum(u, v, st, **kw)
    assert sum(kernels.launch_counts().values()) == 1
    want = momentum.momentum_plain(u, v, st, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept, (u, v, st)))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _edge_zero(g, R)
        if Yb > 2 * R and Xb > 2 * R:
            I = (slice(R, -R), slice(R, -R))
            err = float((g[..., I[0], I[1]] - w[..., I[0], I[1]]).abs().max())
            assert err <= BANDS[dtype] * max(float(w[..., I[0], I[1]].abs().max()), 1e-300)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,n_tr,kappa", [(0, 1, False), (0, 1, True), (4, 1, False),
                                           (4, 2, True), (50, 1, True)])
def test_cuda_tracer_adv_acc(dtype, nz, n_tr, kappa):
    """acc added after the advective tendency and κ_h, column (nz = 0) and layered."""
    r = np.random.default_rng(nz + n_tr + kappa)
    Yb, Xb = 40, 52
    if nz == 0:
        arrays = (*r.standard_normal((3, Yb, Xb)), 1.0 + r.random((8 if kappa else 5, Yb, Xb)))
        layered = ()
    else:
        S = 4 if kappa else 1
        mask = (r.random((nz, Yb, Xb)) > 0.2).astype(np.float64)
        pack = (mask[:, None] * (0.5 + r.random((nz, S, Yb, Xb)))).reshape(-1, Yb, Xb)
        arrays = (r.standard_normal((n_tr * nz, Yb, Xb)),
                  r.standard_normal((nz, Yb, Xb)) * mask,
                  r.standard_normal((nz, Yb, Xb)) * mask, pack)
        layered = (0.5 + r.random((2, Yb, Xb)), 50.0 * 1.1 ** np.arange(nz))
    args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays + layered]
    acc = torch.as_tensor(0.5 * r.standard_normal(args[0].shape), dtype=dtype, device="cuda")
    R = tracer_adv.REACH
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(*args, acc=acc)
    assert sum(kernels.launch_counts().values()) == 1
    want = tracer_adv.tracer_adv_plain(*args, acc=acc)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,n_tr", [(0, 1), (4, 2), (50, 1)])
def test_cuda_tracer_adv_kappa(dtype, nz, n_tr):
    """Column mode (nz = 0: one plane, the 8-plane pack) and layered mode, S = 4."""
    r = np.random.default_rng(nz + n_tr)
    Yb, Xb = 40, 52
    if nz == 0:
        arrays = (*r.standard_normal((3, Yb, Xb)), 1.0 + r.random((8, Yb, Xb)))
        layered = ()
    else:
        mask = (r.random((nz, Yb, Xb)) > 0.2).astype(np.float64)
        pack = (mask[:, None] * (0.5 + r.random((nz, 4, Yb, Xb)))).reshape(-1, Yb, Xb)
        arrays = (r.standard_normal((n_tr * nz, Yb, Xb)),
                  r.standard_normal((nz, Yb, Xb)) * mask,
                  r.standard_normal((nz, Yb, Xb)) * mask, pack)
        layered = (0.5 + r.random((2, Yb, Xb)), 50.0 * 1.1 ** np.arange(nz))
    args = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in arrays + layered]
    R = tracer_adv.REACH
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(*args)
    assert kernels.launch_counts()["tracer_adv_kappa"] == 1
    want = tracer_adv.tracer_adv_plain(*args)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,with_b", [(4, False), (4, True), (50, True)])
def test_cuda_corrector(dtype, nz, with_b):
    """U_a and V_a are views cropped out of wider arrays, as in the step."""
    r = np.random.default_rng(nz + with_b)
    Yb, Xb, d = 40, 52, 6
    mu, mv, mc = (r.random((3, nz, Yb, Xb)) > 0.2)
    dz3 = (40.0 * 1.05 ** np.arange(nz)).reshape(-1, 1, 1)

    def cu(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    stacks = [cu(r.standard_normal((nz, Yb, Xb))) for _ in range(6)]
    tracers = [cu(r.standard_normal((2 * nz, Yb, Xb))) for _ in range(3)]
    b = tuple(cu(r.standard_normal((nz, Yb, Xb))) for _ in range(3)) if with_b else None
    ext = cu(r.standard_normal((2, Yb + 2 * d, Xb + 2 * d)))
    args = (*stacks, *tracers, cu(dz3 * mu), cu(dz3 * mv), cu(mc), cu(r.random((Yb, Xb))),
            cu(r.random((Yb, Xb))), ext[0, d:-d, d:-d], ext[1, d:-d, d:-d],
            cu(1.6), cu(0.6), cu(40.0))
    kernels.reset_launch_counts()
    got = corrector.corrector(*args, b=b)
    assert kernels.launch_counts()["corrector"] == 1
    want = corrector.corrector_plain(*args, b=b)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert _rel_err(g, w, (slice(None), slice(None))) <= BANDS[dtype]
        assert torch.isfinite(g).all()


@needs_cuda
def test_cuda_gyre_steps_match_cpu_float64():
    """Three float64 steps of the 48 x 32 x 3 check gyre through the kernels agree
    with the CPU plain path, and each step launches the gyre's kernels."""
    from examples.wind_driven_ts_gyre_torch import build_check

    cpu_m, cpu_s = build_check(device="cpu")
    gpu_m, gpu_s = build_check(device="cuda")
    kernels.reset_launch_counts()
    gpu_out = TL.layered_multi_step(gpu_m, gpu_s, 60.0, 3)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=6, halo_fill_copy=18, barotropic=3, vertical=3,
                momentum_closures=3, tracer_adv_kappa=3, corrector=3)
    assert kernels.launch_counts() == want
    cpu_out = TL.layered_multi_step(cpu_m, cpu_s, 60.0, 3)
    I3 = (slice(None),) + cpu_m.grid.interior2d
    for name in ("u", "v", "c"):
        w = getattr(cpu_out, name)[I3]
        got = getattr(gpu_out, name).cpu()[I3]
        assert float((got - w).abs().max()) <= 1e-11 * float(w.abs().max()), name


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_baro_substep_sol(dtype):
    """The substep probe on 5 tiles of (8, 128) and (16, 64), 64 substeps: all three
    accumulators against the plain version."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes

    r = np.random.default_rng(9)
    for tile in ((8, 128), (16, 64)):
        shape = (5, 5) + tile
        spack = torch.as_tensor(1e-6 * r.standard_normal(shape), dtype=dtype, device="cuda")
        dpack = torch.as_tensor(r.standard_normal(shape), dtype=dtype, device="cuda")
        dtau = torch.tensor([1e-7], dtype=dtype, device="cuda")
        kernels.reset_launch_counts()
        got = probes.baro_substep_sol(spack, dpack, dtau, 64)
        assert kernels.launch_counts()["baro_substep_sol"] == 1
        want = probes.baro_substep_sol_plain(spack, dpack, dtau, 64)
        assert _rel_err(got, want, (slice(None), slice(None))) <= BANDS[dtype]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("upwind", [True, False])
def test_cuda_weno_probe(dtype, upwind):
    """The WENO-5 probe on 9 rows (a partly filled block) of 1536, 1 and 4
    iterations: a rounding flip of the upwind select may leave at most 1e-4 of the
    points outside the band."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes

    x = torch.as_tensor(np.random.default_rng(0).standard_normal((9, 1536)), dtype=dtype,
                        device="cuda")
    for n_iter in (1, 4):
        kernels.reset_launch_counts()
        got = probes.weno_probe(x, n_iter, upwind)
        assert kernels.launch_counts()["weno_probe"] == 1
        want = probes.weno_probe_plain(x, n_iter, upwind)
        diff = (got - want).abs()
        assert float((diff > BANDS[dtype] * want.abs().max()).double().mean()) < 1e-4
        assert torch.isfinite(got).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_stream_and_fma_ceilings(dtype):
    """The two ceiling kernels against their plain versions, the stream with a
    ragged tail after its 16-byte vectors."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes

    x = torch.as_tensor(np.random.default_rng(1).standard_normal(100003), dtype=dtype,
                        device="cuda")
    kernels.reset_launch_counts()
    got = probes.stream_probe(x)
    assert kernels.launch_counts()["stream_probe"] == 1
    assert float((got - probes.stream_probe_plain(x)).abs().max()) <= \
        BANDS[dtype] * float(x.abs().max())
    xf = torch.full((4099,), 0.999, dtype=dtype, device="cuda")
    got = probes.fma_ceiling(xf, 5)
    assert kernels.launch_counts()["fma_ceiling"] == 1
    want = probes.fma_ceiling_plain(xf, 5)
    assert float((got - want).abs().max()) <= BANDS[dtype] * float(want.abs().max())


@needs_cuda
def test_cuda_simulation_through_the_kernels():
    """Ten iterations of the 48 x 32 x 3 check gyre through ``Simulation`` (the
    wizard every 5, the NaN checker every iteration) launch the gyre's kernels on
    every step and agree with the same run on the CPU."""
    from examples.wind_driven_ts_gyre_torch import build_check
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        IterationInterval, NaNChecker, Simulation, TimeStepWizard)

    def run(device):
        model, state = build_check(device=device)
        sim = Simulation(model, state, dt=60.0, stop_iteration=10)
        wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=600.0)
        sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                         IterationInterval(5))
        sim.add_callback(NaNChecker(("u", "v", "c")), IterationInterval(1))
        return sim.run(), sim

    kernels.reset_launch_counts()
    gpu_out, gpu_sim = run("cuda")
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=20, halo_fill_copy=60, barotropic=10, vertical=10,
                momentum_closures=10, tracer_adv_kappa=10, corrector=10)
    assert kernels.launch_counts() == want
    cpu_out, cpu_sim = run("cpu")
    assert gpu_sim.iteration == cpu_sim.iteration == 10
    assert gpu_sim.dt == pytest.approx(cpu_sim.dt, rel=1e-12) and gpu_sim.dt > 60.0
    I3 = (slice(None),) + gpu_sim.model.grid.interior2d
    for name in ("u", "v", "c"):
        w = getattr(cpu_out, name)[I3]
        got = getattr(gpu_out, name).cpu()[I3]
        assert float((got - w).abs().max()) <= 1e-11 * float(w.abs().max()), name


@needs_cuda
@pytest.mark.parametrize("which", ["bickley", "gyre"])
def test_cuda_simulation_waits_only_where_a_callback_fires(which):
    """Through ``Simulation`` (the wizard and the progress line every 5 iterations) a
    step makes no host synchronization: torch's sync debug mode counts none at the
    iterations where no callback fires, some where the wizard and the progress line
    read the card, and one at every iteration of a run that reads u after each
    step."""
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        IterationInterval, Simulation, TimeStepWizard, progress_callback)
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    if which == "bickley":
        from examples.bickley_jet_torch import build

        model, state = build(48, 32, dtype=torch.float64, substeps=10, device="cuda")
    else:
        from examples.wind_driven_ts_gyre_torch import build_check

        model, state = build_check(device="cuda")

    def syncs(read_every_step):
        sim = Simulation(model, state, dt=60.0, stop_iteration=12, nan_checker=False)
        wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=600.0)
        sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                         IterationInterval(5))
        sim.add_callback(progress_callback(lambda line: None), IterationInterval(5))
        if read_every_step:
            sim.add_callback(lambda s: float(s.state.u.reshape(-1)[0]), IterationInterval(1))
        marks = []
        with host_syncs() as n_syncs:
            sim.add_callback(lambda s: marks.append((s.iteration, n_syncs())),
                             IterationInterval(1))
            sim.run()
        return {it: n - prev for (_, prev), (it, n) in zip(marks, marks[1:])}

    syncs(False)  # loads the kernels and the callbacks' reductions
    quiet = [2, 3, 4, 6, 7, 8, 9, 11, 12]
    plain, read = syncs(False), syncs(True)
    assert sorted(plain) == list(range(2, 13))
    assert all(plain[it] == 0 for it in quiet), plain
    assert plain[5] >= 2 and plain[10] >= 2, plain
    assert all(read[it] >= 1 for it in quiet), read


@needs_cuda
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_cuda_nan_checker_and_progress(bad):
    """On the card the NaN checker sees a NaN or an infinity in a tracer stack, and
    the progress line reads max |u| and max |v| exactly."""
    from examples.wind_driven_ts_gyre_torch import build_check
    from orthogonalsphericalshellgrids_tpu_torch.utils import (NaNChecker, Simulation,
                                                               progress_callback)

    model, state = build_check(device="cuda")
    sim = Simulation(model, TL.layered_multi_step(model, state, 60.0, 2), dt=60.0)
    lines = []
    progress_callback(lines.append)(sim)
    assert lines[0].endswith(f"velocity: {float(sim.state.u.abs().max()):.2e} "
                             f"{float(sim.state.v.abs().max()):.2e}")
    NaNChecker(("u", "v", "c"))(sim)
    sim.state.c[4, 10, 10] = bad
    with pytest.raises(RuntimeError, match="non-finite values in 'c'"):
        NaNChecker(("u", "v", "c"))(sim)
