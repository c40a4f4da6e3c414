"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here needs the card and skips elsewhere with the reason. The file imports
no jax, so it runs on a machine without the JAX package:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Bands (``max |kernel - plain| / max |plain|`` over the valid cells; the kernels follow
the plain versions' arithmetic order and differ only where nvcc contracts a multiply
and an add into one FMA): float32 1e-5, float64 1e-12. The halo fills move data and
multiply by ±1, so the group fill (with and without its save), the group restore
and the out-of-place fill are held bitwise.
"""

import dataclasses
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
@pytest.mark.parametrize("Ny,Nx,K", [(40, 48, 3), (680, 1440, 10)], ids=["small", "quarter"])
def test_cuda_fill_bitwise(dtype, loc, sign, Ny, Nx, K):
    """In place and out of place, on a stack of K planes at halo 5 (the state's) and
    22 (the free surface's); ``quarter``: the 1/4° jet's and front's planes."""
    for H in (5, 22):
        A = torch.as_tensor(np.random.default_rng(H).standard_normal(
            (K, Ny + 2 * H, Nx + 2 * H)), dtype=dtype, device="cuda")
        A0 = A.clone()
        want = halo_fill.fill_halos_plain(A.clone(), loc, sign, Nx, Ny, H, H)
        got = halo_fill.fill_halos(A.clone(), loc, sign, Nx, Ny, H, H)
        copy = halo_fill.fill_halos(A, loc, sign, Nx, Ny, H, H, inplace=False)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(copy, want) and torch.equal(A, A0)


def _fill_group(path, dtype, Ny=40, Nx=48, nz=3):
    """The fill group of a path on the card: the state's fields (stacks of ``nz``
    layers) on Ny x Nx planes at halo 5, and η, U, V as views of one (3, Ye, Xe)
    buffer at halo 22; ``odd``: three fields on planes no block of 256 threads
    divides."""
    r = np.random.default_rng(len(path))

    def cu(shape):
        return torch.as_tensor(r.standard_normal(shape), dtype=dtype, device="cuda")

    if path == "odd":
        return [(cu((3, 13 + 2 * 3, 18 + 2 * 4)), FC, -1, 18, 13, 4, 3),
                (cu((14 + 2 * 2, 22 + 2 * 3)), CF, -1, 22, 14, 3, 2),
                (cu((2, 9 + 2 * 1, 10 + 2 * 2)), FF, 1, 10, 9, 2, 1)]
    stacks = {"bickley": [(None, FC, -1), (None, CF, -1), (None, CC, 1)],
              "front": [(nz, FC, -1), (nz, CF, -1), (nz, CC, 1), (nz, CC, 1)],
              "gyre": [(nz, FC, -1), (nz, CF, -1), (2 * nz, CC, 1)]}[path]
    base = (Ny + 10, Nx + 10)
    fields = [(cu(base if K is None else (K, *base)), loc, s, Nx, Ny, 5, 5)
              for K, loc, s in stacks]
    ext = cu((3, Ny + 44, Nx + 44))
    return fields + [(ext[0], CC, 1, Nx, Ny, 22, 22), (ext[1], FC, -1, Nx, Ny, 22, 22),
                     (ext[2], CF, -1, Nx, Ny, 22, 22)]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path,size", [
    ("bickley", "small"), ("front", "small"), ("gyre", "small"), ("odd", "small"),
    ("bickley", "quarter"), ("front", "quarter"), ("gyre", "quarter")])
def test_cuda_group_fill_and_restore_bitwise(dtype, path, size):
    """One launch fills the group, with and without the save, bitwise the plain
    version's fields and strips; one launch restores every field bitwise. ``quarter``:
    the 1/4° groups, 10 layers."""
    fields = _fill_group(path, dtype, *((680, 1440, 10) if size == "quarter" else ()))
    before = [f[0].clone() for f in fields]
    plain = [(f[0].clone(),) + f[1:] for f in fields]
    want, want_saved = halo_fill.fill_halos_group_plain(plain, save=True)
    kernels.reset_launch_counts()
    got, saved = halo_fill.fill_halos_group(fields, save=True)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(saved, want_saved)
    halo_fill.restore_strips_group(fields, saved)
    torch.cuda.synchronize()
    assert all(torch.equal(f[0], b) for f, b in zip(fields, before))
    got, none = halo_fill.fill_halos_group(fields)
    torch.cuda.synchronize()
    assert none is None and all(torch.equal(g, w) for g, w in zip(got, want))
    halo_fill.restore_strips_group_plain(plain, want_saved)
    assert all(torch.equal(f[0], b) for f, b in zip(plain, before))
    want_counts = {k: 0 for k in kernels.LAUNCHES}
    want_counts.update(halo_fill=2, halo_restore=1)
    assert kernels.launch_counts() == want_counts


@needs_cuda
def test_cuda_group_entries_refuse_another_plan():
    """The C entries check the table against the geometry: a wrong cell count, first
    block, strip offset, fold-strip offset or column offset is refused at launch,
    and nothing is written."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import call

    fields = _fill_group("front", torch.float32)
    before = [f[0].clone() for f in fields]
    geoms, _ = halo_fill._group("t", fields)
    plan = halo_fill.group_plan(geoms)
    saved = torch.empty(plan.n_saved, device="cuda")
    # cells, first block, first strip offset, fold and column offsets of field 1
    for col in (11, 12, 13, 19, 20):
        table = halo_fill._table(fields, geoms)
        table[halo_fill.TABLE_COLS + col] += 1
        with pytest.raises(RuntimeError):
            call("osg_halo_fill_group", torch.float32, saved.device, table, len(fields),
                 saved.data_ptr(), 1, None, None, None, None, None, None, halo_fill.ALL)
        with pytest.raises(RuntimeError):
            call("osg_halo_restore_group", torch.float32, saved.device, table,
                 len(fields), saved.data_ptr(), halo_fill.ALL)
    torch.cuda.synchronize()
    assert all(torch.equal(f[0], b) for f, b in zip(fields, before))


@needs_cuda
@pytest.mark.parametrize("path", ["bickley", "front"])
def test_cuda_steps_leave_the_state_as_it_was(path):
    """Three float64 steps through the kernels with η, U and V views of one buffer:
    each incoming state is bitwise as it was; then a step whose forcing raises
    after the fill leaves it so too."""
    import dataclasses

    def boom(*args):
        raise ValueError("forcing failed")

    if path == "bickley":
        from examples.bickley_jet_torch import build

        model, state = build(48, 40, dtype=torch.float64, substeps=12, device="cuda")
        step = TH.step
    else:
        from examples.wind_driven_ts_gyre_torch import build

        model, state = build(48, 40, 3, dtype=torch.float64, substeps=12, device="cuda")
        step = TL.layered_step
    for i in range(4):
        buf = torch.stack([state.eta, state.U, state.V])
        state = dataclasses.replace(state, eta=buf[0], U=buf[1], V=buf[2])
        snap = {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}
        if i < 3:
            new = step(model, state, 120.0)
        else:
            forcing = model.forcing
            model.forcing = (("u", boom),)
            try:
                with pytest.raises(ValueError, match="forcing failed"):
                    step(model, state, 120.0)
            finally:
                model.forcing = forcing
        torch.cuda.synchronize()
        assert all(torch.equal(getattr(state, k), v) for k, v in snap.items())
        state = new


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("Yb,Xb", [(60, 76), (690, 1450)])
def test_cuda_momentum(dtype, Yb, Xb):
    u, v, static = _mom_inputs(dtype, Yb, Xb)
    R = momentum.REACH
    got = momentum.momentum(u, v, static)
    for g, w in zip(got, momentum.momentum_plain(u, v, static)):
        assert _rel_err(g, w, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
        assert torch.isfinite(g).all()
        assert _edge_zero(g, R)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("Yb,Xb", [(60, 76), (690, 1450)])
def test_cuda_tracer_adv(dtype, Yb, Xb):
    c, u, v, static = _adv_inputs(dtype, Yb, Xb)
    R = tracer_adv.REACH
    got = tracer_adv.tracer_adv(c, u, v, static)
    want = tracer_adv.tracer_adv_plain(c, u, v, static)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all()


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("plane", ["model", "quarter"])
def test_cuda_barotropic(dtype, wrap, plane):
    """30 substeps (21 weights) on a 48 x 40 Bickley jet's own pack, or on random
    planes of the 1/4° jet's extended plane (724 x 1484, halo 22): within the band
    at the interior, finite, the inputs unchanged."""
    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)

    if plane == "model":
        model, _ = build(48, 40, dtype=dtype, substeps=30, device="cuda")
        ge = model.grid_ext
        Ny, Nx, H, Hy = ge.Ny, ge.Nx, ge.Hx, ge.Hy
        ext = (Ny + 2 * Hy, Nx + 2 * H)
        r = np.random.default_rng(9)
        eta, U, V = (halo_fill.fill_halos_plain(
            torch.as_tensor(0.01 * r.standard_normal(ext), dtype=dtype, device="cuda"),
            loc, s, Nx, Ny, H, Hy) for loc, s in ((CC, 1), (FC, -1), (CF, -1)))
        GU, GV = (1e-6 * torch.ones(ext, dtype=dtype, device="cuda") for _ in range(2))
        dtau = model.fractional_dt * torch.as_tensor(120.0, dtype=dtype, device="cuda")
        pack, weights = model.baro_pack, model.weights
    else:
        Ny, Nx, H, Hy = 680, 1440, 22, 22
        pack, eta, U, V, GU, GV = _baro_inputs(Ny, Nx, H, dtype, seed=9)
        dtau = torch.tensor(0.01, dtype=dtype, device="cuda")
        weights = torch.as_tensor(averaging_weights(30)[1], dtype=dtype, device="cuda")
    args = (pack, eta, U, V, GU, GV, dtau, weights, Nx, H, wrap)
    I = (slice(Hy, Hy + Ny), slice(H, H + Nx))
    inputs = [a.clone() for a in (pack, eta, U, V, GU, GV)]
    for got, want in zip(barotropic.barotropic_substeps(*args),
                         barotropic.barotropic_substeps_plain(*args)):
        assert _rel_err(got, want, I) <= BANDS[dtype]
        assert torch.isfinite(got).all()
    for a, a0 in zip((pack, eta, U, V, GU, GV), inputs):  # read in place
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
                     1, *eta.shape, 30, 8, 0, 7, 32, 48)
    with pytest.raises(ValueError, match="x-wrap"):
        barotropic.barotropic_substeps(static, eta, U, V, GU, GV, dtau, w, 29, 8, True)


# the schemes of the single-layer model that leave a kernel of the step to PyTorch
JET_OPTIONS = {"weno5": {}, "weno7": dict(tracer_advection="weno7"),
               "upwind3": dict(tracer_advection="upwind3"),
               "centered": dict(tracer_advection="centered"),
               "centered4": dict(tracer_advection="centered4"),
               "vector_invariant": dict(momentum_advection="vector_invariant")}


def _equatorial(p):
    """The equatorial refinement of ``tests/test_tripolar_grid.py:238``."""
    return 1.0 - 0.5 * torch.exp(-((p / 15.0) ** 2))


def _refined_jet(device):
    """The 48 x 40 float64 jet's model on the equatorially refined grid, with a
    zonal jet and the example's tracer."""
    from examples.bickley_jet_torch import bottom_height

    from orthogonalsphericalshellgrids_tpu_torch import TripolarGrid
    from orthogonalsphericalshellgrids_tpu_torch.models import SplitExplicitFreeSurface

    grid = TripolarGrid.make((48, 40, 1), halo=(5, 5, 5), first_pole_longitude=45.0,
                             north_poles_latitude=25.0, dtype=torch.float64, device=device,
                             phi_spacing=_equatorial)
    model = TH.make_model(grid, free_surface=SplitExplicitFreeSurface(substeps=30),
                          bottom_height=bottom_height(), device=device)
    return model, TH.initial_state(
        model, u=lambda lam, phi: 1.0 / np.cosh(np.deg2rad(phi) * 8) ** 2,
        c=lambda lam, phi: np.sin(2 * np.pi * np.deg2rad(phi) * 8 / 167.0))


@needs_cuda
@pytest.mark.parametrize("case", list(JET_OPTIONS) + ["refined"])
def test_cuda_steps_match_cpu_float64(case):
    """Five float64 steps of the 48 x 40 jet through the kernels agree with the CPU
    plain path (u, v, c, η), with each tracer and momentum scheme and on the
    equatorially refined grid (whose extended grid carries the law); a step launches
    momentum unless the momentum scheme is the plain vector-invariant one, and the
    tracer kernel only for WENO-5."""
    from examples.bickley_jet_torch import build

    if case == "refined":
        cpu_m, cpu_s = _refined_jet("cpu")
        gpu_m, gpu_s = _refined_jet("cuda")
        assert gpu_m.grid.phi_spacing is _equatorial
        assert gpu_m.grid_ext.phi_spacing is _equatorial
        ge = gpu_m.grid_ext
        assert torch.equal(ge.interior(ge.phi_cc), gpu_m.grid.interior(gpu_m.grid.phi_cc))
        opts = {}
    else:
        opts = JET_OPTIONS[case]
        cpu_m, cpu_s = build(48, 40, dtype=torch.float64, substeps=30, device="cpu", **opts)
        gpu_m, gpu_s = build(48, 40, dtype=torch.float64, substeps=30, device="cuda",
                             **opts)
    TH.multi_step(gpu_m, gpu_s, 120.0, 5)  # captures the block after one eager step
    kernels.reset_launch_counts()
    gpu_out = TH.multi_step(gpu_m, gpu_s, 120.0, 5)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=10, halo_restore=5, barotropic=5,
                momentum=5 * ("momentum_advection" not in opts),
                tracer_adv=5 * ("tracer_advection" not in opts))
    assert kernels.launch_counts() == want
    cpu_out = TH.multi_step(cpu_m, cpu_s, 120.0, 5)
    for name in ("u", "v", "c", "eta"):
        grid = cpu_m.grid_ext if name == "eta" else cpu_m.grid
        want = grid.interior(getattr(cpu_out, name))
        got = grid.interior(getattr(gpu_out, name).cpu())
        assert float((got - want).abs().max()) <= 1e-11 * float(want.abs().max()), name


# ----------------------------------------------------------------------------------
# the layered kernels
# ----------------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode,nz,mixing,plane", [
    ("none", 4, False, (40, 52)), ("tracer_b", 4, True, (40, 52)),
    ("linear_eos", 4, True, (40, 52)), ("linear_eos", 4, False, (40, 52)),
    ("tracer_b", 50, True, (40, 52))] + [
    (mode, 4, mixing, plane) for plane in ((7, 9), (135, 171))
    for mode in ("none", "tracer_b", "linear_eos") for mixing in (False, True)] + [
    ("none", 10, False, (690, 1450)), ("tracer_b", 10, True, (690, 1450)),
    ("linear_eos", 10, True, (690, 1450)), ("linear_eos", 75, True, (40, 1450)),
    ("linear_eos", 75, False, (40, 1450))])
def test_cuda_vertical(dtype, mode, nz, mixing, plane):
    """One launch against the plain version on the mask pack built from the same
    wet-layer counts (drawn from 0 to Nz a column), on planes no tile divides, one
    of them smaller than a tile: every mode with and without ν_v and κ_v; the 1/4°
    front's and gyre's calls on their plane, and OM4p25's (T and S, 75 levels) on a
    strip of its rows."""
    _vertical_case(dtype, mode, nz, mixing, 2 if mode == "linear_eos" else 1, *plane)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode,n_c", [("tracer_b", 2), ("linear_eos", 3), ("none", 4)])
def test_cuda_vertical_more_tracers(dtype, mode, n_c):
    """Three and four tracer blocks: the kernel carries the first two in registers and
    reads the others at each layer."""
    _vertical_case(dtype, mode, 6, True, n_c, 40, 52)


def _vertical_case(dtype, mode, nz, mixing, n_c, Yb, Xb):
    r = np.random.default_rng(nz)
    n_wet = np.minimum(r.integers(0, nz + 3, (Yb, Xb)), nz).astype(np.int32)
    _, mu, mv = vertical.wet_pack(torch.as_tensor(n_wet), nz, 3,
                                   torch.float64).reshape(nz, 3, Yb, Xb).transpose(0, 1)
    c = r.standard_normal((n_c * nz, Yb, Xb))
    if mode == "linear_eos":
        c[:nz] += 10.0
        c[nz:2 * nz] = 35.0 + 0.1 * c[nz:2 * nz]
    dz = [50.0 * 1.05 ** k for k in range(nz)]
    dzc = [0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1)]
    coef = vertical.coefficients(dz, dzc, 1e-3 if mixing else 0.0, 1e-5 if mixing else 0.0)
    arrays = [r.standard_normal((nz, Yb, Xb)) * mu.numpy(),
              r.standard_normal((nz, Yb, Xb)) * mv.numpy(), c,
              r.standard_normal((nz, Yb, Xb)) if mode == "tracer_b" else None]
    args = [None if a is None else torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in arrays]
    g, coef = (torch.as_tensor(a, dtype=dtype, device="cuda")
               for a in (0.5 + r.random((5, Yb, Xb)), coef))
    n_wet = torch.as_tensor(n_wet, device="cuda")
    kw = dict(mode=mode, eos=(9.81, 1.67e-4, 7.8e-4, 10.0, 35.0),
              it_T=0 if mode == "linear_eos" else -1, it_S=1 if mode == "linear_eos" else -1,
              viscous=mixing, diffusive=mixing)
    kept = [a.clone() for a in args if a is not None]
    kernels.reset_launch_counts()
    got = vertical.vertical(*args, n_wet, g, coef, **kw)
    assert kernels.launch_counts()["vertical"] == 1
    s_pack = vertical.wet_pack(n_wet, nz, 3 if mixing else 1, dtype)
    for g_, w in zip(got, vertical.vertical_plain(*args, s_pack, g, coef, **kw)):
        assert _rel_err(g_, w, (slice(1, -1), slice(1, -1))) <= BANDS[dtype]
        assert torch.isfinite(g_).all()
        assert _edge_zero(g_, vertical.REACH)
    assert all(torch.equal(a, b) for a, b in zip(kept, (a for a in args if a is not None)))


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,Yb,Xb", [(3, 60, 76), (10, 690, 1450), (75, 40, 1450)])
def test_cuda_layered_momentum(dtype, nz, Yb, Xb):
    """Unmasked layers without operands: a small stack, the 1/4° front's and a strip
    of OM4p25's rows at its 75 levels."""
    r = np.random.default_rng(1)
    u, v = (torch.as_tensor(a, dtype=dtype, device="cuda")
            for a in r.standard_normal((2, nz, Yb, Xb)))
    static = 1.0 + r.random((8, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))
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
@pytest.mark.parametrize("nz,Yb,Xb", [(3, 60, 76), (10, 690, 1450), (75, 40, 1450)])
def test_cuda_layered_tracer_adv(dtype, n_tr, nz, Yb, Xb):
    """A small stack, the 1/4° front's plane and a strip of OM4p25's rows at its 75
    levels, over masked velocities."""
    r = np.random.default_rng(n_tr)
    mask = (r.random((nz, Yb, Xb)) > 0.2).astype(np.float64)
    dz = np.array([50.0, 120.0, 300.0]) if nz == 3 else 2.0 + 250.0 * (
        np.arange(nz) / (nz - 1)) ** 2
    arrays = (r.standard_normal((nz * n_tr, Yb, Xb)), r.standard_normal((nz, Yb, Xb)) * mask,
              r.standard_normal((nz, Yb, Xb)) * mask, mask * (0.5 + r.random((nz, Yb, Xb))),
              0.5 + r.random((2, Yb, Xb)), dz)
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
    TL.layered_multi_step(gpu_m, gpu_s, 120.0, 3)  # captures the block
    kernels.reset_launch_counts()
    gpu_out = TL.layered_multi_step(gpu_m, gpu_s, 120.0, 3)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=6, halo_restore=3, barotropic=3, vertical=3,
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
@pytest.mark.parametrize("nz,has_lap,has_drag,Yb,Xb", [
    (1, True, True, 40, 52), (4, True, True, 40, 52), (4, False, True, 40, 52),
    (50, True, True, 40, 52), (75, True, True, 40, 1450)])
def test_cuda_momentum_closures(dtype, nz, has_lap, has_drag, Yb, Xb):
    """One masked layer (nz = 1, the single-layer model) or an unmasked stack; at 75
    levels OM4p25's call (ν_h and quadratic drag) on a strip of its rows."""
    r = np.random.default_rng(nz + has_lap)
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
    (1, False, False, "acc"), (1, False, False, "both"), (1, True, True, "acc"),
    (1, True, True, "both"), (4, False, False, "both"), (4, False, False, "mask_out"),
    (4, True, True, "both"), (4, False, True, "acc"), (4, True, False, "both"),
    (50, True, True, "both")])
@pytest.mark.parametrize("Yb,Xb", [(40, 52), (7, 9), (37, 131), (135, 171), (690, 1450)])
def test_cuda_momentum_operands(dtype, nz, has_lap, has_drag, operands, Yb, Xb):
    """The tiled kernel with acc and/or mask_out in each mode, on planes smaller than
    a tile, planes no tile divides and the 1/4° plane: within the band, finite, the
    REACH cells 0, the inputs unchanged, one launch."""
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
@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("kappa", [False, True])
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("Yb,Xb", [(40, 52), (37, 131)])
def test_cuda_tracer_adv_planes(dtype, P, kappa, with_acc, Yb, Xb):
    """The column mode over P planes (one launch, counted as ``tracer_adv_planes``)
    against its plain version, and each plane bitwise equal to a one-plane launch
    on it (some rows of the later planes exactly 0, as on land)."""
    r = np.random.default_rng(P + 2 * kappa + 4 * with_acc)
    c = r.standard_normal((P, Yb, Xb))
    c[1:, : Yb // 3] = 0.0
    u, v = r.standard_normal((2, Yb, Xb))
    static = 1.0 + r.random((8 if kappa else 5, Yb, Xb))
    c, u, v, static = (torch.as_tensor(a, dtype=dtype, device="cuda")
                       for a in (c, u, v, static))
    acc = (torch.as_tensor(0.5 * r.standard_normal((P, Yb, Xb)), dtype=dtype,
                           device="cuda") if with_acc else None)
    R = tracer_adv.REACH
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(c, u, v, static, acc=acc)
    counts = kernels.launch_counts()
    assert counts["tracer_adv_planes"] == 1 and sum(counts.values()) == 1
    want = tracer_adv.tracer_adv_plain(c, u, v, static, acc=acc)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all() and _edge_zero(got, R)
    for p in range(P):
        one = tracer_adv.tracer_adv(c[p].contiguous(), u, v, static,
                                    acc=None if acc is None else acc[p].contiguous())
        assert torch.equal(got[p], one), f"plane {p}"


@needs_cuda
def test_cuda_tracer_adv_entry_refuses():
    """The column entry refuses a plan made for another tile and n_planes < 1, and
    writes nothing; the wrapper refuses a pack of any size but 5 or 8 and an empty
    stack before any launch."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import call

    c, u, v, static = _adv_inputs(torch.float32)
    c3 = torch.stack([c, 2.0 * c])
    G = torch.full_like(c3, 7.0)
    Yb, Xb = c.shape
    TY, TX = tracer_adv.launch_plan(Yb, Xb, torch.float32).tile
    for n_planes, tile in ((2, (TY // 2, TX)), (2, (TY, 2 * TX)), (0, (TY, TX)),
                           (-1, (TY, TX))):
        with pytest.raises(RuntimeError):
            call("osg_tracer_adv", torch.float32, c.device, c3.data_ptr(), u.data_ptr(),
                 v.data_ptr(), static.data_ptr(), None, G.data_ptr(), n_planes, Yb, Xb,
                 0, *tile)
    torch.cuda.synchronize()
    assert (G == 7.0).all()
    kernels.reset_launch_counts()
    for bad in (static[:4], torch.cat([static, static[:1]]),
                torch.cat([static, static[:2]])):
        with pytest.raises(ValueError, match="column pack"):
            tracer_adv.tracer_adv(c3, u, v, bad.contiguous())
    with pytest.raises(ValueError, match="P >= 1"):
        tracer_adv.tracer_adv(c3[:0], u, v, static)
    assert sum(kernels.launch_counts().values()) == 0


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,n_tr,kappa", [(0, 1, False), (0, 1, True), (4, 1, False),
                                           (4, 2, False), (4, 1, True), (4, 2, True),
                                           (50, 1, True)])
@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("Yb,Xb", [(40, 52), (7, 9), (37, 131), (135, 171), (690, 1450)])
def test_cuda_tracer_adv_acc(dtype, nz, n_tr, kappa, with_acc, Yb, Xb):
    """Every mode of the tracer kernel, column (nz = 0: the 5- and 8-plane packs) and
    layered (1 and 2 tracers, S = 1 and 4), with and without acc (added after the
    advective tendency and κ_h), on planes smaller than a tile, planes no tile
    divides and the 1/4° plane: within the band, finite, the REACH cells 0, the
    inputs unchanged, one launch."""
    r = np.random.default_rng(nz + n_tr + kappa + Yb)
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
    acc = (torch.as_tensor(0.5 * r.standard_normal(args[0].shape), dtype=dtype,
                           device="cuda") if with_acc else None)
    kept = [a.clone() for a in args]
    R = tracer_adv.REACH
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(*args, acc=acc)
    assert sum(kernels.launch_counts().values()) == 1
    want = tracer_adv.tracer_adv_plain(*args, acc=acc)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kept, args))
    assert torch.isfinite(got).all()
    assert _edge_zero(got, R)
    if Yb > 2 * R and Xb > 2 * R:
        I = (slice(R, -R), slice(R, -R))
        err = float((got[..., I[0], I[1]] - want[..., I[0], I[1]]).abs().max())
        assert err <= BANDS[dtype] * max(float(want[..., I[0], I[1]].abs().max()), 1e-300)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz,n_tr,Yb,Xb", [(0, 1, 40, 52), (4, 2, 40, 52), (50, 1, 40, 52),
                                           (75, 2, 40, 1450)])
def test_cuda_tracer_adv_kappa(dtype, nz, n_tr, Yb, Xb):
    """Column mode (nz = 0: one plane, the 8-plane pack) and layered mode, S = 4; at
    75 levels OM4p25's T and S on a strip of its rows."""
    r = np.random.default_rng(nz + n_tr)
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
@pytest.mark.parametrize("nz,with_b,Yb,Xb", [
    (4, False, 40, 52), (4, True, 40, 52), (50, True, 40, 52), (10, False, 690, 1450),
    (10, True, 690, 1450), (75, False, 40, 1450)])
def test_cuda_corrector(dtype, nz, with_b, Yb, Xb):
    """U_a and V_a are views cropped out of wider arrays, as in the step: small
    stacks, the 1/4° gyre's (T and S) and front's (c and b) plane, and a strip of
    OM4p25's rows at its 75 levels."""
    r = np.random.default_rng(nz + with_b)
    d = 6
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
    with the CPU plain path (u, v, c, η), and each step launches the gyre's
    kernels."""
    from examples.wind_driven_ts_gyre_torch import build_check

    cpu_m, cpu_s = build_check(device="cpu")
    gpu_m, gpu_s = build_check(device="cuda")
    TL.layered_multi_step(gpu_m, gpu_s, 60.0, 3)  # captures the block
    kernels.reset_launch_counts()
    gpu_out = TL.layered_multi_step(gpu_m, gpu_s, 60.0, 3)
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=6, halo_restore=3, barotropic=3, vertical=3,
                momentum_closures=3, tracer_adv_kappa=3, corrector=3)
    assert kernels.launch_counts() == want
    cpu_out = TL.layered_multi_step(cpu_m, cpu_s, 60.0, 3)
    for name in ("u", "v", "c", "eta"):
        grid = cpu_m.grid_ext if name == "eta" else cpu_m.grid
        w = grid.interior(getattr(cpu_out, name))
        got = grid.interior(getattr(gpu_out, name).cpu())
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
    every step and agree with the same run on the CPU. The first run on the card
    captures the one-step block (after one eager step); the second is counted."""
    from examples.wind_driven_ts_gyre_torch import build_check
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        IterationInterval, NaNChecker, Simulation, TimeStepWizard)

    built = {"cuda": build_check(device="cuda"), "cpu": build_check(device="cpu")}

    def run(device):
        model, state = built[device]
        sim = Simulation(model, state, dt=60.0, stop_iteration=10)
        wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=600.0)
        sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                         IterationInterval(5))
        sim.add_callback(NaNChecker(("u", "v", "c")), IterationInterval(1))
        return sim.run(), sim

    run("cuda")
    kernels.reset_launch_counts()
    gpu_out, gpu_sim = run("cuda")
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=20, halo_restore=10, barotropic=10, vertical=10,
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
def test_cuda_simulation_counts_every_wait_where_it_happens(tmp_path):
    """Under a profiler, over 200 iterations of a ``Simulation`` on the graphs (the
    progress line and the wizard every 10, the NaN check every 100, u, v, c and ζ
    written every 50), the program's ``wait.*`` counters sum to what torch's sync
    debug mode counts, plus the run's final ``torch.cuda.synchronize``, which that
    mode does not report: every wait is counted where it happens. The state is cloned
    out of the graphs' buffers once a cycle of 10, inside the callback that reads it
    first."""
    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch.models.diagnostics import vertical_vorticity
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        IterationInterval, OutputWriter, Simulation, TimeStepWizard, profiling,
        progress_callback)
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    model, state = build(48, 32, dtype=torch.float32, substeps=10, device="cuda")
    sim = Simulation(model, state, dt=60.0, stop_iteration=20)
    wizard = TimeStepWizard(cfl=0.3, max_change=1.1, max_dt=60.0)
    sim.add_callback(progress_callback(lambda line: None), IterationInterval(10))
    sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                     IterationInterval(10))
    sim.add_callback(OutputWriter(str(tmp_path / "out.npz"), {
        "u": lambda s: s.state.u, "v": lambda s: s.state.v, "c": lambda s: s.state.c,
        "zeta": lambda s: vertical_vorticity(s.model, s.state)}), IterationInterval(50))
    sim.run()  # the capture, the kernels and every callback once
    sim.stop_iteration = 220
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        with host_syncs() as n_syncs:
            sim.run()
            syncs = n_syncs()
    counts, spans = profiling.counters(), profiling.spans()
    assert counts == {"wait.sim.progress": 20, "wait.sim.wizard": 20,
                      "wait.sim.nan_check": 2, "wait.output.copy": 16, "wait.sim.end": 1}
    assert sum(counts.values()) == syncs + 1
    clones = [s for s in spans if s.name == "osg.sim.clone"]
    assert [s.key for s in clones] == list(range(30, 221, 10))
    for s in clones:
        assert spans[s.parent].name == ("osg.sim.nan_check" if s.key % 100 == 0
                                        else "osg.sim.progress"), s
        assert spans[s.parent].key == s.key


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


def _shard_group(path, dtype, ny):
    """A path's fill group on one rank of ``ny`` rows, on the card: base fields at
    halo 5, η, U, V views of one buffer at halo min(22, ny)."""
    r = np.random.default_rng(ny + len(path))
    he = min(22, ny)

    def cu(shape):
        return torch.as_tensor(r.standard_normal(shape), dtype=dtype, device="cuda")

    stacks = {"bickley": [(None, FC, -1), (None, CF, -1), (None, CC, 1)],
              "gyre": [(3, FC, -1), (3, CF, -1), (6, CC, 1)]}[path]
    plane = (ny + 10, 58)
    fields = [(cu(plane if K is None else (K,) + plane), loc, s, 48, ny, 5, 5)
              for K, loc, s in stacks]
    ext = cu((3, ny + 2 * he, 48 + 2 * he))
    return fields + [(ext[0], CC, 1, 48, ny, he, he), (ext[1], FC, -1, 48, ny, he, he),
                     (ext[2], CF, -1, 48, ny, he, he)]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ny", [22, 40])
@pytest.mark.parametrize("role", ["bottom", "middle", "top"])
@pytest.mark.parametrize("path", ["bickley", "gyre"])
def test_cuda_shard_fill_and_restore_bitwise(dtype, ny, role, path):
    """In each shard role the pack, the fill with save (reading the received rows)
    and the restore are bitwise their plain versions, one launch each, also where
    the rank holds only as many rows as the extended halo (ny = 22); so is the
    split's order, the local x-wrap and then the rest of the fill into the same saved
    buffer, against the one-launch plain fill and its strips."""
    role = {"bottom": halo_fill.BOTTOM, "middle": halo_fill.MIDDLE,
            "top": halo_fill.TOP}[role]
    fields = _shard_group(path, dtype, ny)
    before = [f[0].clone() for f in fields]
    kernels.reset_launch_counts()
    send = halo_fill.pack_strips(fields, role)
    torch.cuda.synchronize()
    assert torch.equal(send, halo_fill.pack_strips_plain(fields, role))
    part = send.numel() // 2
    recv = torch.as_tensor(np.random.default_rng(5).standard_normal(2 * part),
                           dtype=dtype, device="cuda")
    has_s, has_n = halo_fill.receives(role)
    south, north = (recv[:part] if has_s else None), (recv[part:] if has_n else None)
    plain = [(f[0].clone(),) + f[1:] for f in fields]
    want, want_saved = halo_fill.fill_halos_group_plain(plain, save=True, role=role,
                                                        south=south, north=north)
    got, saved = halo_fill.fill_halos_group(fields, save=True, role=role, south=south,
                                            north=north)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(saved, want_saved)
    halo_fill.restore_strips_group(fields, saved, role=role)
    torch.cuda.synchronize()
    assert all(torch.equal(f[0], b) for f, b in zip(fields, before))
    saved = halo_fill.wrap_halos_group(fields, role)
    halo_fill.fill_halos_group(fields, True, role, south=south, north=north,
                               phase=halo_fill.NO_WRAP, saved=saved)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(saved, want_saved)
    halo_fill.restore_strips_group(fields, saved, role=role)
    torch.cuda.synchronize()
    assert all(torch.equal(f[0], b) for f, b in zip(fields, before))
    want_counts = {k: 0 for k in kernels.LAUNCHES}
    want_counts.update(halo_pack=1, halo_fill_shard=2, halo_wrap=1, halo_restore=2)
    assert kernels.launch_counts() == want_counts


def _sharded_case(which, nx):
    """(model, state, serial block, kernels a step, the split's tendency kernels) of
    a float64 case on the card: the nx x 40 jet (substeps 12), with WENO-7 tracer
    advection (radius 4, left to PyTorch) or with a second tracer, or the check
    gyre."""
    if which == "gyre":
        from examples.wind_driven_ts_gyre_torch import build_check

        model, state = build_check(device="cuda")
        split = ("vertical", "momentum_closures", "tracer_adv_kappa")
        return model, state, TL.layered_multi_step, ("barotropic", "corrector") + split, split
    from examples.bickley_jet_torch import build

    model, state = build(nx, 40, dtype=torch.float64, substeps=12, device="cuda",
                         **JET_OPTIONS["weno7" if which == "bickley_weno7" else "weno5"])
    if which == "bickley_two_tracers":
        model, state = _two_tracers(model, state)
    split = ("momentum",) + {"bickley": ("tracer_adv",), "bickley_weno7": (),
                             "bickley_two_tracers": ("tracer_adv_planes",)}[which]
    return model, state, TH.multi_step, ("barotropic",) + split, split


@needs_cuda
@pytest.mark.parametrize("which", ["bickley", "bickley_weno7", "bickley_two_tracers",
                                   "gyre"])
def test_cuda_local_exchange_step_bitwise(which):
    """Four shards stepped through LocalExchange on the card, 3 float64 steps, split
    (the default) and unsplit: the gathered state is bitwise the serial steps', each
    shard launches its kernels the expected number of times a step (with the split
    the tendency kernels three times: the bulk pass and its two row strips), and the
    sharded steps make no host synchronization. WENO-7 takes the split at its radius
    of 4; two tracers take the P-plane launch on every pass."""
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    model, state, serial, kernels_a_step, split = _sharded_case(which, 48)
    want = serial(model, state, 60.0, 3)
    for overlap in (None, False):
        fn, s, gather = _sharded(model, state, 4, which == "gyre", overlap)
        fn(s, 60.0)  # loads the kernels; s is left as it was
        fn.launches = [dict.fromkeys(kernels.LAUNCHES, 0) for _ in fn.launches]
        with host_syncs() as n_syncs:
            for _ in range(3):
                s = fn(s, 60.0)
            syncs = n_syncs()
        fn.close()
        got = gather(s)
        for name in ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc"):
            grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
            assert torch.equal(grid.interior(getattr(got, name)),
                               grid.interior(getattr(want, name))), (name, overlap)
        assert syncs == 0
        passes = 3 if overlap is None else 1
        for counts in fn.launches:
            assert all(counts[k] == 3 * (passes if k in split else 1)
                       for k in kernels_a_step), counts
            assert counts["halo_pack"] == counts["halo_fill_shard"] == 6, counts
            assert counts["halo_wrap"] == (3 if overlap is None else 0), counts
            assert counts["halo_restore"] == 3 and counts["halo_fill"] == 0, counts


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_barotropic_rows_independent_of_the_plane(dtype):
    """The barotropic kernel on an extended plane and on the row blocks of 4 ranks
    gives every rank's interior the same bits: a cell's arithmetic does not depend
    on its row within the time tile (the y-flux is rounded before its difference)."""
    r = np.random.default_rng(0)
    Ny, Nx, H, n = 40, 48, 9, 4
    ny = Ny // n

    def cu(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    static = cu(1 + r.random((9, Ny + 2 * H, Nx + 2 * H)))
    static[7:] = cu((r.random((2, Ny + 2 * H, Nx + 2 * H)) > 0.1).astype(float))
    eta, U, V, GU, GV = (cu(r.standard_normal((Ny + 2 * H, Nx + 2 * H))) for _ in range(5))
    w, dtau = cu(r.random(8)), cu(np.array(1e-3))
    full = barotropic.barotropic_substeps(static, eta, U, V, GU, GV, dtau, w, Nx, H, False)
    for k in range(n):
        def rows(a):
            return a[..., k * ny:k * ny + ny + 2 * H, :].contiguous()

        part = barotropic.barotropic_substeps(*map(rows, (static, eta, U, V, GU, GV)), dtau,
                                              w, Nx, H, False)
        for name, f, p in zip(("eta", "U", "V"), full, part):
            assert torch.equal(rows(f)[H:H + ny, H:H + Nx], p[H:H + ny, H:H + Nx]), \
                f"rank {k} {name}"


# ----------------------------------------------------------------------------------
# 2-D (x, y) blocks and the overlap split
# ----------------------------------------------------------------------------------

def _block_fields(path, dtype, n_x, n_y, nx_b, ny_b, seed=0):
    """The fill group of a path on every block of an (n_x, n_y) mesh of blocks of
    ny_b x nx_b cells, on the card: {(ix, iy): fields}. Base fields at halo 5, η, U,
    V at halo 22, views of one buffer, random everywhere (the halos too)."""
    r = np.random.default_rng(seed)
    stacks = {"bickley": [(None, FC, -1), (None, CF, -1), (None, CC, 1)],
              "gyre": [(3, FC, -1), (3, CF, -1), (6, CC, 1)]}[path]
    out = {}
    for iy in range(n_y):
        for ix in range(n_x):
            def cu(shape):
                return torch.as_tensor(r.standard_normal(shape), dtype=dtype, device="cuda")

            plane = (ny_b + 10, nx_b + 10)
            fields = [(cu(plane if K is None else (K,) + plane), loc, s, nx_b, ny_b, 5, 5)
                      for K, loc, s in stacks]
            ext = cu((3, ny_b + 44, nx_b + 44))
            out[ix, iy] = fields + [(ext[0], CC, 1, nx_b, ny_b, 22, 22),
                                    (ext[1], FC, -1, nx_b, ny_b, 22, 22),
                                    (ext[2], CF, -1, nx_b, ny_b, 22, 22)]
    return out


def check_block_fills(path, dtype, n_x, n_y, nx_b, ny_b, fold_mode):
    """Every block of the mesh through the 2-D route, launch by launch, each launch
    against its plain version on the same inputs: the pack of the rows and fold
    strip, the inner phase with its save (reading the packs it receives), the pack of
    the columns, the outer phase saving into the same buffer, and the restore, which
    gives every field back. All bitwise. Returns the number of launches held."""
    from orthogonalsphericalshellgrids_tpu_torch.ops.spmd2d import Spmd2D
    from orthogonalsphericalshellgrids_tpu_torch.parallel.distributed import _rows2d

    blocks = _block_fields(path, dtype, n_x, n_y, nx_b, ny_b)
    spmds = {k: Spmd2D(k[0], k[1], n_x, n_y, n_x * nx_b, None, fold_mode) for k in blocks}
    before = {k: [f[0].clone() for f in fs] for k, fs in blocks.items()}
    plain = {k: [(f[0].clone(),) + f[1:] for f in fs] for k, fs in blocks.items()}
    held = 0

    def packs(kind):
        nonlocal held
        got = {}
        for k, fs in blocks.items():
            got[k] = halo_fill.pack_strips(fs, spmds[k].role, kind)
            torch.cuda.synchronize()
            assert torch.equal(got[k], halo_fill.pack_strips_plain(fs, spmds[k].role,
                                                                   kind)), (k, kind)
            held += 1
        return {spmds[k].rank: v for k, v in got.items()}

    plan = {k: halo_fill.group_plan(halo_fill.group_geometry(fs, spmds[k].role))
            for k, fs in blocks.items()}
    sent = packs(halo_fill.ROWS)
    saved = {}
    for k, fs in blocks.items():
        sp, pl = spmds[k], plan[k]
        lows = n_y > 1 and ny_b == 22
        south, north, strips, below = _rows2d(sp, sent.__getitem__, pl.part_len,
                                              pl.fold_len, lows)
        kw = dict(save=True, role=sp.role, south=south, north=north,
                  phase=halo_fill.INNER, strips=strips, lows=below)
        want, want_saved = halo_fill.fill_halos_group_plain(plain[k], **kw)
        _, saved[k] = halo_fill.fill_halos_group(fs, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(f[0], w) for f, w in zip(fs, want)), k
        held += 1
        saved[k + ("plain",)] = want_saved
    sent = packs(halo_fill.COLUMNS)
    for k, fs in blocks.items():
        sp, cl = spmds[k], plan[k].col_len
        west = sent[sp.rank_of((sp.ix - 1) % n_x, sp.iy)][:cl]
        east = sent[sp.rank_of((sp.ix + 1) % n_x, sp.iy)][cl:]
        kw = dict(save=True, role=sp.role, phase=halo_fill.OUTER, west=west, east=east)
        want, want_saved = halo_fill.fill_halos_group_plain(
            plain[k], saved=saved[k + ("plain",)], **kw)
        halo_fill.fill_halos_group(fs, saved=saved[k], **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(f[0], w) for f, w in zip(fs, want)), k
        assert torch.equal(saved[k], want_saved), k
        halo_fill.restore_strips_group(fs, saved[k], role=sp.role)
        torch.cuda.synchronize()
        assert all(torch.equal(f[0], b) for f, b in zip(fs, before[k])), k
        held += 2
    return held


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh,mode", [((2, 2), "gather"), ((4, 1), "mirror"),
                                       ((3, 1), "gather"), ((3, 2), "mirror")])
@pytest.mark.parametrize("path", ["bickley", "gyre"])
def test_cuda_block_fill_pack_and_restore_bitwise(dtype, mesh, mode, path):
    """Every role of 2 x 2, 4 x 1 (mirror), 3 x 1 (the middle block straddles the
    fold's middle column) and 3 x 2 meshes of 24-column blocks: the 2-D route's
    launches bitwise their plain versions, at ny = 40 and at the least ny the
    extended grid takes (22, where the top blocks' strips reach a row of the blocks
    below; 23 for one row of blocks); one launch a call."""
    n = mesh[0] * mesh[1]
    for ny_b in (22 if mesh[1] > 1 else 23, 40):
        kernels.reset_launch_counts()
        held = check_block_fills(path, dtype, *mesh, 24, ny_b, mode)
        want = {k: 0 for k in kernels.LAUNCHES}
        want.update(halo_pack_block=2 * n, halo_fill_block=2 * n, halo_restore=n)
        assert kernels.launch_counts() == want and held == 5 * n


def _cells_equal(full, part, rows, cols, keep_rows, keep_cols):
    """The cells ``keep_rows`` x ``keep_cols`` of ``part`` (cut from ``full`` at
    ``rows``, ``cols``) equal the same cells of ``full``."""
    return torch.equal(full[..., rows, cols][..., keep_rows, keep_cols],
                       part[..., keep_rows, keep_cols])


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["bickley", "gyre"])
def test_cuda_tendencies_independent_of_the_origin(dtype, which):
    """The tendency kernels (momentum, tracer advection and, for the gyre, the
    vertical kernel) on the blocks of a 3 x 2 mesh and on the split's 3·H-wide row
    and column strips give every cell of the block's interior (of the strip's
    middle third) the bits of the same cell of the whole plane: a cell's arithmetic
    does not depend on where its tile falls."""
    from orthogonalsphericalshellgrids_tpu_torch import parallel
    from orthogonalsphericalshellgrids_tpu_torch.models.hydrostatic import strip_views

    if which == "bickley":
        from examples.bickley_jet_torch import build

        model, state = build(96, 80, dtype=dtype, substeps=12, device="cuda")
        fields = [state.u, state.v, state.c]
        grid = model.grid

        def tend(m, f):
            return TH.tendencies(m, *f)
    else:
        from examples.wind_driven_ts_gyre_torch import build_check

        model, state = build_check(dtype=dtype, device="cuda")
        fields = [state.u, state.v, state.c]
        grid = model.grid

        def tend(m, f):
            return TL.layered_tendencies(m, *f, state.b)[:3]
    for (f, loc, sign) in zip(fields, (FC, CF, CC), (-1, -1, 1)):
        halo_fill.fill_halos(f, loc, sign, grid.Nx, grid.Ny, grid.Hx, grid.Hy)
    full = tend(model, fields)
    Hy, Hx, Ny, Nx = grid.Hy, grid.Hx, grid.Ny, grid.Nx
    # strips of the serial plane
    views = strip_views(model, two_d=True)
    cuts = [(slice(0, 3 * Hy), slice(None)), (slice(Ny - Hy, Ny + 2 * Hy), slice(None)),
            (slice(None), slice(0, 3 * Hx)), (slice(None), slice(Nx - Hx, Nx + 2 * Hx))]
    for view, (rows, cols) in zip(views, cuts):
        part = tend(view, [f[..., rows, cols].contiguous() for f in fields])
        keep = ((slice(Hy, 2 * Hy), slice(3, -3)) if cols == slice(None) else
                (slice(3, -3), slice(Hx, 2 * Hx)))
        for name, a, b in zip("uvc", full, part):
            assert _cells_equal(a, b, rows, cols, *keep), (name, rows, cols)
    # x- and y-shifted blocks
    mesh = parallel.make_mesh2d(3, 2)
    dist = (parallel.distribute2d if which == "bickley" else
            parallel.distribute_layered2d)(model, state, mesh)[0]
    ny, nx = Ny // 2, Nx // 3
    for k, m in enumerate(dist):
        ky, kx = divmod(k, 3)
        rows = slice(ky * ny, ky * ny + ny + 2 * Hy)
        cols = slice(kx * nx, kx * nx + nx + 2 * Hx)
        part = tend(m, [f[..., rows, cols].contiguous() for f in fields])
        for name, a, b in zip("uvc", full, part):
            assert _cells_equal(a, b, rows, cols, slice(3, -3), slice(3, -3)), (name, k)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_barotropic_columns_independent_of_the_plane(dtype):
    """The barotropic kernel (wrap off) on the column blocks of 3 x-ranks and on a
    3·H-wide column strip gives the cells its validity keeps the bits of the whole
    plane's: x-blocks move its tiles in x as y-blocks move them in y."""
    r = np.random.default_rng(1)
    Ny, Nx, H, n = 40, 48, 9, 3
    nx = Nx // n
    n_sub = 8  # validity shrinks one cell a substep into the H-wide halo

    def cu(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    static = cu(1 + r.random((9, Ny + 2 * H, Nx + 2 * H)))
    static[7:] = cu((r.random((2, Ny + 2 * H, Nx + 2 * H)) > 0.1).astype(float))
    eta, U, V, GU, GV = (cu(r.standard_normal((Ny + 2 * H, Nx + 2 * H))) for _ in range(5))
    w, dtau = cu(r.random(n_sub)), cu(np.array(1e-3))
    full = barotropic.barotropic_substeps(static, eta, U, V, GU, GV, dtau, w, Nx, H, False)
    for c0, width in [(k * nx, nx + 2 * H) for k in range(n)] + [(4, 3 * H)]:
        def cols(a):
            return a[..., c0:c0 + width].contiguous()

        part = barotropic.barotropic_substeps(*map(cols, (static, eta, U, V, GU, GV)),
                                              dtau, w, width - 2 * H, H, False)
        keep = slice(n_sub + 1, width - n_sub - 1)
        for name, f, p in zip(("eta", "U", "V"), full, part):
            assert torch.equal(cols(f)[H:H + Ny, keep], p[H:H + Ny, keep]), \
                f"columns from {c0} {name}"


@needs_cuda
@pytest.mark.parametrize("which,mesh,mode", [("bickley", (2, 2), "auto"),
                                             ("bickley", (4, 1), "mirror"),
                                             ("bickley_weno7", (2, 2), "auto"),
                                             ("gyre", (2, 2), "auto")])
def test_cuda_local_exchange_2d_step_bitwise(which, mesh, mode):
    """Blocks of a 2-D mesh stepped through LocalExchange on the card, 3 float64
    steps: bitwise the serial steps, split and unsplit alike, each block launching
    the 2-D route's kernels the expected number of times, with no host
    synchronization. WENO-7 takes the split at its radius of 4."""
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    model, state, serial, _, split = _sharded_case(which, 96)
    want = serial(model, state, 60.0, 3)
    for overlap in (None, False):
        fn, s, gather = _sharded(model, state, mesh, which == "gyre", overlap, mode)
        fn(s, 60.0)  # loads the kernels; s is left as it was
        fn.launches = [dict.fromkeys(kernels.LAUNCHES, 0) for _ in fn.launches]
        with host_syncs() as n_syncs:
            for _ in range(3):
                s = fn(s, 60.0)
            syncs = n_syncs()
        fn.close()
        got = gather(s)
        for name in ("u", "v", "c", "eta", "U", "V", "Gu", "Gv", "Gc"):
            grid = model.grid_ext if name in ("eta", "U", "V") else model.grid
            assert torch.equal(grid.interior(getattr(got, name)),
                               grid.interior(getattr(want, name))), (name, overlap)
        assert syncs == 0
        for counts in fn.launches:
            assert counts["barotropic"] == 3, counts
            assert all(counts[k] == 3 * (5 if overlap is None else 1) for k in split), \
                counts
            # two groups a step, each two packs and two fill phases
            assert counts["halo_pack_block"] == counts["halo_fill_block"] == 12, counts
            assert counts["halo_restore"] == 3 and counts["halo_wrap"] == 0, counts
            assert counts["halo_pack"] == counts["halo_fill_shard"] == 0, counts


# ------------------------------------------------------------------------------------
# ensembles: the member axis of the barotropic, tracer and momentum kernels
# ------------------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("substeps,Ny,Nx", [(10, 10, 12), (24, 53, 37), (44, 61, 97)])
@pytest.mark.parametrize("B", [1, 3, 4])
def test_cuda_barotropic_members(dtype, wrap, substeps, Ny, Nx, B):
    """B members in one wrapper call (one ``barotropic`` count) at odd shapes: each
    member bitwise its own one-member call, the stack within the band of the plain
    version, the inputs unchanged."""
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)

    w = averaging_weights(substeps)[1]
    n_sub, H = len(w), len(w) + 1
    sets = [_baro_inputs(Ny, Nx, H, dtype, seed=substeps + 7 * b) for b in range(B)]
    static = sets[0][0]
    stacks = [torch.stack([s[k] for s in sets]) for k in range(1, 6)]
    kept = [a.clone() for a in stacks]
    tail = (torch.tensor(0.01, dtype=dtype, device="cuda"),
            torch.as_tensor(w, dtype=dtype, device="cuda"), Nx, H, wrap)
    kernels.reset_launch_counts()
    got = barotropic.barotropic_substeps(static, *stacks, *tail)
    assert kernels.launch_counts()["barotropic"] == 1
    assert all(g.shape == (B, Ny + 2 * H, Nx + 2 * H) and g.is_contiguous() for g in got)
    want = barotropic.barotropic_substeps_plain(static, *stacks, *tail)
    I = (slice(n_sub, -n_sub), slice(None) if wrap else slice(n_sub, -n_sub))
    for g, ww in zip(got, want):
        assert _rel_err(g, ww, I) <= BANDS[dtype]
        assert torch.isfinite(g).all()
    for b in range(B):
        one = barotropic.barotropic_substeps(static, *(s[b] for s in stacks), *tail)
        for name, g, o in zip(("eta", "U", "V"), got, one):
            assert torch.equal(g[b], o), (b, name)
    for a, a0 in zip(stacks, kept):
        assert torch.equal(a, a0)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,n", [(2, 1), (3, 1), (4, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("kappa", [False, True])
@pytest.mark.parametrize("with_acc", [False, True])
def test_cuda_tracer_adv_members(dtype, B, n, kappa, with_acc):
    """The member mode (one launch, counted as ``tracer_adv_members``) against its
    plain version, and each member's plane bitwise a one-plane launch over that
    member's u and v (some rows of the later planes exactly 0, as on land)."""
    Yb, Xb = 37, 131
    r = np.random.default_rng(B + 5 * n + 11 * kappa + 23 * with_acc)
    shape = (B, Yb, Xb) if n == 1 else (B, n, Yb, Xb)
    c = r.standard_normal(shape)
    c[1:, ..., : Yb // 3, :] = 0.0
    u, v = r.standard_normal((2, B, Yb, Xb))
    static = 1.0 + r.random((8 if kappa else 5, Yb, Xb))
    c, u, v, static = (torch.as_tensor(a, dtype=dtype, device="cuda")
                       for a in (c, u, v, static))
    acc = (torch.as_tensor(0.5 * r.standard_normal(shape), dtype=dtype, device="cuda")
           if with_acc else None)
    R = tracer_adv.REACH
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(c, u, v, static, acc=acc)
    counts = kernels.launch_counts()
    assert counts["tracer_adv_members"] == 1 and sum(counts.values()) == 1
    want = tracer_adv.tracer_adv_plain(c, u, v, static, acc=acc)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all() and _edge_zero(got, R)
    g4 = got.reshape(B, n, Yb, Xb)
    c4, a4 = c.reshape(B, n, Yb, Xb), None if acc is None else acc.reshape(B, n, Yb, Xb)
    for b in range(B):
        for t in range(n):
            one = tracer_adv.tracer_adv(c4[b, t].contiguous(), u[b].contiguous(),
                                        v[b].contiguous(), static,
                                        acc=None if a4 is None else a4[b, t].contiguous())
            assert torch.equal(g4[b, t], one), (b, t)


@needs_cuda
def test_cuda_tracer_adv_members_route_and_refusals():
    """One member takes the column (or P-plane) launch; the member entry refuses
    planes that the members do not divide and a plan for another tile, writing
    nothing."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import call

    c, u, v, static = _adv_inputs(torch.float32)
    kernels.reset_launch_counts()
    one = tracer_adv.tracer_adv(c[None].contiguous(), u[None].contiguous(),
                                v[None].contiguous(), static)
    assert kernels.launch_counts()["tracer_adv"] == 1
    assert torch.equal(one[0], tracer_adv.tracer_adv(c, u, v, static))
    Yb, Xb = c.shape
    c3, u2, v2 = torch.stack([c, c, c]), torch.stack([u, u]), torch.stack([v, v])
    G = torch.full_like(c3, 7.0)
    TY, TX = tracer_adv.launch_plan(Yb, Xb, torch.float32).tile
    for n_planes, n_members, tile in ((3, 2, (TY, TX)), (2, 2, (TY // 2, TX)),
                                      (2, 0, (TY, TX))):
        with pytest.raises(RuntimeError):
            call("osg_tracer_adv_members", torch.float32, c.device, c3.data_ptr(),
                 u2.data_ptr(), v2.data_ptr(), static.data_ptr(), None, G.data_ptr(),
                 n_planes, n_members, Yb, Xb, 0, *tile)
    torch.cuda.synchronize()
    assert (G == 7.0).all()
    with pytest.raises(ValueError, match="members"):
        tracer_adv.tracer_adv(c3, u2, v2, static)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("closures", [False, True])
def test_cuda_momentum_members(dtype, closures):
    """A (B, Yb, Xb) member stack with the masked 10-plane pack through the kernel's
    layer loop: each member bitwise its one-plane launch, with the closure pack
    repeated per member when it is given, and so is the ensemble's launch of one pack
    with period 1."""
    B = 4
    r = np.random.default_rng(31 + closures)
    u, v, static = _mom_inputs(dtype, seed=31)
    u = torch.as_tensor(r.standard_normal((B,) + tuple(u.shape)), dtype=dtype,
                        device="cuda")
    v = torch.as_tensor(r.standard_normal(tuple(u.shape)), dtype=dtype, device="cuda")
    lay = (torch.as_tensor(0.1 * (0.5 + r.random((8,) + tuple(u.shape[1:]))), dtype=dtype,
                           device="cuda") if closures else None)
    kw = dict(has_lap=closures, has_drag=closures)
    got = momentum.momentum(u, v, static, lay=None if lay is None else lay.repeat(B, 1, 1),
                            **kw)
    # the ensemble's call: one pack, repeating every layer (period 1)
    one_pack = momentum.momentum(u, v, static, lay=lay, period=1, **kw)
    assert torch.equal(got[0], one_pack[0]) and torch.equal(got[1], one_pack[1])
    for b in range(B):
        one = momentum.momentum(u[b].contiguous(), v[b].contiguous(), static, lay=lay, **kw)
        assert torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1]), b


def _two_tracers(model, state):
    """The 48 x 40 jet's ``model`` (substeps 12) with a second tracer, c², on its grid
    and bottom, and ``state`` with it."""
    from examples.bickley_jet_torch import bottom_height

    from orthogonalsphericalshellgrids_tpu_torch.models import SplitExplicitFreeSurface

    two = TH.make_model(model.grid, free_surface=SplitExplicitFreeSurface(substeps=12),
                        bottom_height=bottom_height(), tracers=("c", "d"), device="cuda")
    c = torch.stack([state.c, state.c * state.c])
    return two, dataclasses.replace(state, c=c, Gc=torch.zeros_like(c))


def _scaled(state, s):
    """``state`` (one or a batch, of either model) with its fields times ``s`` (t and
    iteration kept), as ``tests/test_ensemble.py`` makes its members."""
    return type(state)(**{f.name: getattr(state, f.name) * s
                          if f.name not in ("t", "iteration") else getattr(state, f.name)
                          for f in dataclasses.fields(state)})


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_tracers", [1, 2])
def test_cuda_ensemble_step_bitwise(dtype, n_tracers):
    """Three members (at iterations 0, 1 and 0) stepped together on the card: each
    bitwise its own serial steps, and a step launching each kernel as often as one
    serial step does. With two tracers a serial step advects both in one P-plane
    launch, and each member's flow and each of its tracer planes is bitwise the
    one-tracer model's run on that plane."""
    from examples.bickley_jet_torch import build

    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble

    jet, base = build(48, 40, dtype=dtype, substeps=12, device="cuda")
    model = jet
    if n_tracers > 1:  # a second tracer, c², on the same grid and bottom
        model, base = _two_tracers(jet, base)
    serial = [_scaled(base, s) for s in (0.5, 1.0, 1.5)]
    serial[1] = TH.step(model, serial[1], 60.0)
    batch = ensemble.stack_members(serial)
    kernels.reset_launch_counts()
    ensemble.ensemble_step(model, batch, 60.0)
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    TH.step(model, serial[0], 60.0)
    assert {k: v for k, v in counts.items() if v} == {
        "halo_fill": 2, "halo_restore": 1, "barotropic": 1, "momentum": 1,
        "tracer_adv_members": 1}, counts
    serial_counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert serial_counts == {
        "halo_fill": 2, "halo_restore": 1, "barotropic": 1, "momentum": 1,
        "tracer_adv_planes" if n_tracers > 1 else "tracer_adv": 1}, serial_counts
    out = ensemble.ensemble_multi_step(model, batch, 60.0, 3)
    flow = ("u", "v", "eta", "U", "V", "Gu", "Gv", "t", "iteration")
    for i, s in enumerate(serial):
        want = TH.multi_step(model, s, 60.0, 3)
        got = ensemble.member(out, i)
        for name in flow + ("c", "Gc"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (i, name)
        for k in range(n_tracers if n_tracers > 1 else 0):
            one = TH.multi_step(jet, dataclasses.replace(s, c=s.c[k], Gc=s.Gc[k]), 60.0, 3)
            assert all(torch.equal(getattr(want, n), getattr(one, n)) for n in flow), (i, k)
            assert torch.equal(want.c[k], one.c) and torch.equal(want.Gc[k], one.Gc), (i, k)


# ------------------------------------------------------------------------------------
# ensembles of the layered model: the member axis of the vertical, corrector, layered
# momentum and layered tracer kernels
# ------------------------------------------------------------------------------------

def _member_vertical_args(dtype, mode, B, nz=4, Yb=37, Xb=131, seed=0):
    """(u, v, c, b) stacks of B members over one count plane, metric pack and
    coefficient stack, and the call's keywords (ν_v and κ_v on)."""
    r = np.random.default_rng(seed)
    n_wet = np.minimum(r.integers(0, nz + 3, (Yb, Xb)), nz).astype(np.int32)
    _, mu, mv = vertical.wet_pack(torch.as_tensor(n_wet), nz, 3,
                                   torch.float64).reshape(nz, 3, Yb, Xb).transpose(0, 1)
    n_c = 2 if mode == "linear_eos" else 1
    c = r.standard_normal((B, n_c * nz, Yb, Xb))
    if mode == "linear_eos":
        c[:, :nz] += 10.0
        c[:, nz:] = 35.0 + 0.1 * c[:, nz:]
    dz = [50.0 * 1.05 ** k for k in range(nz)]
    coef = vertical.coefficients(dz, [0.5 * (dz[k] + dz[k + 1]) for k in range(nz - 1)],
                                 1e-3, 1e-5)
    arrays = [r.standard_normal((B, nz, Yb, Xb)) * mu.numpy(),
              r.standard_normal((B, nz, Yb, Xb)) * mv.numpy(), c,
              r.standard_normal((B, nz, Yb, Xb)) if mode == "tracer_b" else None,
              n_wet, 0.5 + r.random((5, Yb, Xb)), coef]
    args = [None if a is None else torch.as_tensor(
        a, dtype=torch.int32 if a.dtype == np.int32 else dtype, device="cuda")
        for a in arrays]
    kw = dict(mode=mode, eos=(9.81, 1.67e-4, 7.8e-4, 10.0, 35.0),
              it_T=0 if n_c == 2 else -1, it_S=1 if n_c == 2 else -1, viscous=True,
              diffusive=True)
    return args, kw


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "tracer_b", "linear_eos"])
@pytest.mark.parametrize("B", [1, 3])
def test_cuda_vertical_members(dtype, mode, B):
    """B members' vertical terms in one launch (``vertical_members``; one member
    counts as ``vertical``) within the band of the plain version, each member bitwise
    its one-member launch, the inputs unchanged."""
    args, kw = _member_vertical_args(dtype, mode, B, seed=B + len(mode))
    kept = [a.clone() for a in args if a is not None]
    kernels.reset_launch_counts()
    got = vertical.vertical(*args, **kw)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"vertical_members" if B > 1 else "vertical": 1}, counts
    u, v, c, b, n_wet, g, coef = args
    want = vertical.vertical_plain(u, v, c, b, vertical.wet_pack(n_wet, u.shape[1], 3, dtype),
                                   g, coef, **kw)
    for a, w in zip(got, want):
        assert _rel_err(a, w, (slice(1, -1), slice(1, -1))) <= BANDS[dtype]
        assert torch.isfinite(a).all() and _edge_zero(a, vertical.REACH)
    for m in range(B):
        one = vertical.vertical(u[m], v[m], c[m], None if b is None else b[m], n_wet, g,
                                coef, **kw)
        for a, o in zip(got, one):
            assert torch.equal(a[m], o), m
    assert all(torch.equal(a, k) for a, k in zip((a for a in args if a is not None), kept))


def _member_corrector_args(dtype, B, with_b, nz=4, n_c=8, Yb=37, Xb=131, seed=0):
    r = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    stacks = [t(r.standard_normal((B, nz, Yb, Xb))) for _ in range(6)]
    tracers = [t(r.standard_normal((B, n_c, Yb, Xb))) for _ in range(3)]
    masks = [t(r.random((nz, Yb, Xb)) > 0.2) for _ in range(3)]
    dz3 = t(np.linspace(10.0, 400.0, nz)).view(-1, 1, 1)
    ext = t(r.standard_normal((2, B, Yb + 10, Xb + 14)))
    shared = [dz3 * masks[0], dz3 * masks[1], masks[2], t(r.random((Yb, Xb))),
              t(r.random((Yb, Xb)))]
    crops = [ext[0, :, 5:5 + Yb, 7:7 + Xb], ext[1, :, 5:5 + Yb, 7:7 + Xb]]
    b = tuple(t(r.standard_normal((B, nz, Yb, Xb))) for _ in range(3)) if with_b else None
    return stacks + tracers + shared + crops, b


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_b", [False, True])
@pytest.mark.parametrize("per_member_dt", [False, True])
def test_cuda_corrector_members(dtype, with_b, per_member_dt):
    """Three members in one launch (``corrector_members``), each with its own w1, w2
    (one at its first step) and its own crop of the widened U_a, V_a: within the band
    of the plain version, each member bitwise its one-member launch."""
    B = 3
    args, b = _member_corrector_args(dtype, B, with_b, seed=7 + with_b)
    w1 = torch.tensor([1.0, 1.6, 1.6], dtype=dtype, device="cuda")
    w2 = torch.tensor([0.0, 0.6, 0.6], dtype=dtype, device="cuda")
    dt = torch.tensor([40.0, 40.0, 20.0] if per_member_dt else 40.0, dtype=dtype,
                      device="cuda")
    kernels.reset_launch_counts()
    got = corrector.corrector(*args, w1, w2, dt, b=b)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"corrector_members": 1}, counts
    want = corrector.corrector_plain(*args, w1, w2, dt, b=b)
    for a, w in zip(got, want):
        assert (a is None) == (w is None)
        if a is not None:
            assert _rel_err(a, w, (slice(None), slice(None))) <= BANDS[dtype]
    for m in range(B):
        member_args = [a[m] if k < 9 or k >= 14 else a for k, a in enumerate(args)]
        one = corrector.corrector(*member_args, w1[m], w2[m], dt[m] if per_member_dt else dt,
                                  b=None if b is None else tuple(x[m] for x in b))
        for a, o in zip(got, one):
            assert (a is None and o is None) or torch.equal(a[m], o), m


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("closures", [False, True])
def test_cuda_momentum_period_members(dtype, closures):
    """Three layered members of 4 layers as 12 layers with period 4 (one closure pack
    and one closing mask, acc per layer; ``momentum_members``) within the band of the
    plain version, each member bitwise its one-member launch."""
    B, nz, Yb, Xb = 3, 4, 37, 131
    r = np.random.default_rng(41 + closures)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    u, v = t(r.standard_normal((B * nz, Yb, Xb))), t(r.standard_normal((B * nz, Yb, Xb)))
    static = 1.0 + r.random((8, Yb, Xb))
    static[3] = 0.1 * r.standard_normal((Yb, Xb))
    kw = dict(has_mask=False, mask_out=tuple(t(r.random((nz, Yb, Xb)) > 0.2)
                                             for _ in range(2)))
    if closures:
        lay = 0.5 + r.random((nz, 8, Yb, Xb))
        lay[:, 6:] *= 0.1
        kw.update(lay=t(lay.reshape(-1, Yb, Xb)), has_lap=True, has_drag=True)
    acc = tuple(t(0.5 * r.standard_normal((B * nz, Yb, Xb))) for _ in range(2))
    kernels.reset_launch_counts()
    got = momentum.momentum(u, v, t(static), acc=acc, period=nz, **kw)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"momentum_members": 1}, counts
    R = momentum.REACH
    want = momentum.momentum_plain(u, v, t(static), acc=acc, period=nz, **kw)
    for a, w in zip(got, want):
        assert _rel_err(a, w, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
        assert torch.isfinite(a).all() and _edge_zero(a, R)
    for m in range(B):
        sl = slice(m * nz, (m + 1) * nz)
        one = momentum.momentum(u[sl], v[sl], t(static), acc=tuple(a[sl] for a in acc), **kw)
        for a, o in zip(got, one):
            assert torch.equal(a[sl], o), m


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_tr", [1, 2])
@pytest.mark.parametrize("kappa", [False, True])
@pytest.mark.parametrize("acc_kind", [None, "stack", "view"])
def test_cuda_tracer_adv_layered_members(dtype, n_tr, kappa, acc_kind):
    """Three layered members in one launch (``tracer_adv_layered_members``), acc
    absent, a stack, or a view with its own member stride: within the band of the
    plain version, finite with the edge 0, each member bitwise its one-member
    launch."""
    B, nz, Yb, Xb = 3, 4, 37, 131
    r = np.random.default_rng(n_tr + 3 * kappa + 7 * len(str(acc_kind)))

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    mask = r.random((nz, Yb, Xb)) > 0.2
    u, v = (t(r.standard_normal((B, nz, Yb, Xb)) * mask) for _ in range(2))
    c = r.standard_normal((B, n_tr * nz, Yb, Xb))
    c[1:, :, : Yb // 3] = 0.0  # exact zeros, as on land
    c = t(c)
    S = 4 if kappa else 1
    pack = t(((0.5 + r.random((nz, S, Yb, Xb))) * mask[:, None]).reshape(nz * S, Yb, Xb))
    g2, dz = t(0.5 + r.random((2, Yb, Xb))), t([50.0, 120.0, 300.0, 500.0])
    acc = None
    if acc_kind == "stack":
        acc = t(0.5 * r.standard_normal(tuple(c.shape)))
    elif acc_kind == "view":
        acc = t(0.5 * r.standard_normal((B, (n_tr + 1) * nz, Yb, Xb)))[:, :n_tr * nz]
    kernels.reset_launch_counts()
    got = tracer_adv.tracer_adv(c, u, v, pack, g2, dz, acc=acc)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"tracer_adv_layered_members": 1}, counts
    R = tracer_adv.REACH
    want = tracer_adv.tracer_adv_plain(c, u, v, pack, g2, dz, acc=acc)
    assert _rel_err(got, want, (slice(R, -R), slice(R, -R))) <= BANDS[dtype]
    assert torch.isfinite(got).all() and _edge_zero(got, R)
    for m in range(B):
        one = tracer_adv.tracer_adv(c[m], u[m], v[m], pack, g2, dz,
                                    acc=None if acc is None else acc[m])
        assert torch.equal(got[m], one), m


@needs_cuda
def test_cuda_member_entries_refuse():
    """The member entries refuse no member (n_members 0: the vertical and layered
    tracer entries) and a period that does not divide the layers (momentum), writing
    nothing; one layered member through the 4-D wrappers is the one-stack launch."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import call

    args, kw = _member_vertical_args(torch.float32, "tracer_b", 1, seed=5)
    u, v, c, b, n_wet, g, coef = args
    kernels.reset_launch_counts()
    one = vertical.vertical(*args, **kw)
    assert kernels.launch_counts()["vertical"] == 1
    for a, o in zip(one, vertical.vertical(u[0], v[0], c[0], b[0], n_wet, g, coef, **kw)):
        assert torch.equal(a[0], o)
    nz, Yb, Xb = u.shape[1:]
    out = [torch.full_like(u, 7.0) for _ in range(2)] + [torch.full((1, 2 * nz, Yb, Xb), 7.0,
                                                                    device="cuda")]
    plan = vertical.launch_plan(nz, Yb, Xb, torch.float32)
    with pytest.raises(RuntimeError):
        call("osg_vertical", torch.float32, u.device, u.data_ptr(), v.data_ptr(),
             c.data_ptr(), b.data_ptr(), n_wet.data_ptr(), g.data_ptr(), coef.data_ptr(),
             *(o.data_ptr() for o in out), nz, 1, 2, Yb, Xb, vertical.MODES["tracer_b"], -1,
             -1, 1, 1, *plan.tile, plan.chunk, 0, *kw["eos"])
    u2, v2, static = _mom_inputs(torch.float32)
    u4 = torch.stack([u2] * 4)
    G = [torch.full_like(u4, 7.0) for _ in range(2)]
    with pytest.raises(RuntimeError):
        call("osg_momentum", torch.float32, u4.device, u4.data_ptr(), u4.data_ptr(),
             static.data_ptr(), None, None, None, None, None, G[0].data_ptr(),
             G[1].data_ptr(), 4, *u2.shape, 3, 0, 0, 0,
             *momentum.launch_plan(*u2.shape, torch.float32).tile)
    pack, dz = torch.ones((4, *u2.shape), device="cuda"), torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        call("osg_tracer_adv_layered", torch.float32, u4.device, u4.data_ptr(),
             u4.data_ptr(), u4.data_ptr(), pack.data_ptr(), static.data_ptr(), dz.data_ptr(),
             None, G[0].data_ptr(), 4, 4, *u2.shape, 0, 0, 0,
             *tracer_adv.launch_plan(*u2.shape, torch.float32).tile)
    torch.cuda.synchronize()
    assert all((o == 7.0).all() for o in out + G)
    with pytest.raises(ValueError, match="period"):
        momentum.momentum(u4, u4, static[:8].contiguous(), has_mask=False, period=3)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("config", ["gyre", "front"])
def test_cuda_layered_ensemble_step_bitwise(dtype, config):
    """Three layered members (at iterations 0, 1 and 0) stepped together on the card:
    the check gyre (wind, quadratic drag, ν_h, κ_h, T and S) and the front (c and b),
    each member bitwise its own serial steps, a step launching as many kernels as
    one serial step, each through its member launch."""
    from examples.baroclinic_front_torch import build as front
    from examples.wind_driven_ts_gyre_torch import build_check

    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble

    if config == "gyre":
        model, base = build_check(dtype=dtype, device="cuda")
    else:
        model, base = front(48, 40, 3, dtype=dtype, substeps=12, device="cuda")
    names = [f.name for f in dataclasses.fields(TL.LayeredState)]
    serial = [_scaled(base, f) for f in (0.5, 1.0, 1.5)]
    serial[1] = TL.layered_step(model, serial[1], 60.0)
    batch = ensemble.stack_members(serial)
    kernels.reset_launch_counts()
    ensemble.ensemble_step(model, batch, 60.0)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    kernels.reset_launch_counts()
    TL.layered_step(model, serial[0], 60.0)
    serial_counts = {k: v for k, v in kernels.launch_counts().items() if v}
    n_adv = 1 if config == "gyre" else 2  # the front advects c and b
    assert counts == {"halo_fill": 2, "halo_restore": 1, "barotropic": 1,
                      "vertical_members": 1, "momentum_members": 1,
                      "tracer_adv_layered_members": n_adv, "corrector_members": 1}, counts
    assert sum(serial_counts.values()) == sum(counts.values()), serial_counts
    out = ensemble.ensemble_multi_step(model, batch, 60.0, 3)
    for i, s in enumerate(serial):
        want = TL.layered_multi_step(model, s, 60.0, 3)
        got = ensemble.member(out, i)
        for n in names:
            assert torch.equal(getattr(got, n), getattr(want, n)), (i, n)


# ------------------------------------------------------------------------------------
# ensembles of sharded runs: the member launches at a rank's and a strip's shapes, the
# sharded ensemble steps
# ------------------------------------------------------------------------------------

def _outputs(r):
    return [a for a in (r if isinstance(r, tuple) else (r,)) if a is not None]


def _hold_member_case(kname, case, B, dtype):
    """One launch counted as ``kname``, within the band of the plain version, finite,
    each member bitwise its one-member launch at the same shape."""
    kernels.reset_launch_counts()
    got = _outputs(case["run"]())
    assert {k: n for k, n in kernels.launch_counts().items() if n} == {kname: 1}
    for g, w in zip(got, _outputs(case["plain"]())):
        assert _rel_err(g, w, case["I"]) <= BANDS[dtype], kname
        assert torch.isfinite(g).all(), kname
    for m in range(B):
        for g, o in zip(got, _outputs(case["one"](m))):
            assert torch.equal(g[case["part"](m)], o), (kname, m)


def _rnd(dtype, seed):
    r = np.random.default_rng(seed)

    def rnd(shape, scale=1.0, lo=None):
        a = r.random(shape) + lo if lo is not None else scale * r.standard_normal(shape)
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    return rnd


def _member_cases(rnd, dtype, B, Yb, Xb, nz, bulk):
    """The member launches of the sharded ensembles on a (Yb, Xb) plane of a rank or
    of a split's strip, B members: the jet's (``tracer_adv_members``; ``momentum``
    over the B members as layers, period 1, the masked pack) and the gyre's T and S
    through the linear EOS with the closure planes (``vertical_members``,
    ``momentum_members`` over B·Nz layers with period Nz, ``tracer_adv_layered_members``
    with dGc a view), and on a rank's plane (``bulk``) the corrector over the members,
    each member with its own weights (member 0 at its first step) and its crop of the
    rank's widened U_a, V_a. Each case: the member launch, member m's one-member
    launch and the part of the outputs it gives, the plain version, the valid
    cells."""
    R_adv = (slice(tracer_adv.REACH, Yb - tracer_adv.REACH),
             slice(tracer_adv.REACH, Xb - tracer_adv.REACH))
    R_mom = (slice(momentum.REACH, Yb - momentum.REACH),
             slice(momentum.REACH, Xb - momentum.REACH))
    cases = {}
    uj, vj, cj = rnd((B, Yb, Xb)), rnd((B, Yb, Xb)), rnd((B, Yb, Xb))
    cj[1:, : Yb // 3] = 0.0  # exact zeros, as on land
    pack5 = rnd((5, Yb, Xb), lo=1.0)
    st10 = rnd((10, Yb, Xb), lo=1.0)
    st10[3] = 0.1 * rnd((Yb, Xb))
    st10[8:] = (st10[8:] > 1.15).to(dtype)
    cases["tracer_adv_members"] = dict(
        run=lambda: tracer_adv.tracer_adv(cj, uj, vj, pack5),
        one=lambda m: tracer_adv.tracer_adv(cj[m], uj[m], vj[m], pack5), part=lambda m: m,
        plain=lambda: tracer_adv.tracer_adv_plain(cj, uj, vj, pack5), I=R_adv)
    cases["momentum"] = dict(
        run=lambda: momentum.momentum(uj, vj, st10, period=1),
        one=lambda m: momentum.momentum(uj[m], vj[m], st10), part=lambda m: m,
        plain=lambda: momentum.momentum_plain(uj, vj, st10, period=1), I=R_mom)
    n_wet = torch.as_tensor(np.minimum(np.random.default_rng(Yb * Xb).integers(
        0, nz + 3, (Yb, Xb)), nz), dtype=torch.int32, device="cuda")
    mc, mu, mv = (m.contiguous() for m in vertical.wet_pack(n_wet, nz, 3, dtype).reshape(
        nz, 3, Yb, Xb).transpose(0, 1))
    u, v = rnd((B, nz, Yb, Xb)) * mu, rnd((B, nz, Yb, Xb)) * mv
    c = rnd((B, 2 * nz, Yb, Xb))
    c[:, :nz] += 10.0
    c[:, nz:] = 35.0 + 0.1 * c[:, nz:]
    dzs = [10.0 * 1.7 ** k for k in range(nz)]
    vkw = dict(mode="linear_eos", eos=(9.80665, 1.67e-4, 7.8e-4, 0.0, 35.0), it_T=0,
               it_S=1, viscous=True, diffusive=True)
    g5 = rnd((5, Yb, Xb), lo=0.5)
    coef = torch.as_tensor(vertical.coefficients(
        dzs, [0.5 * (dzs[k] + dzs[k + 1]) for k in range(nz - 1)], 1e-3, 1e-5),
        dtype=dtype, device="cuda")
    s_pack = vertical.wet_pack(n_wet, nz, 3, dtype)
    cases["vertical_members"] = dict(
        run=lambda: vertical.vertical(u, v, c, None, n_wet, g5, coef, **vkw),
        one=lambda m: vertical.vertical(u[m], v[m], c[m], None, n_wet, g5, coef, **vkw),
        part=lambda m: m,
        plain=lambda: vertical.vertical_plain(u, v, c, None, s_pack, g5, coef, **vkw),
        I=(slice(1, Yb - 1), slice(1, Xb - 1)))
    ul, vl = u.reshape(B * nz, Yb, Xb), v.reshape(B * nz, Yb, Xb)
    st8 = rnd((8, Yb, Xb), lo=1.0)
    st8[3] = 0.1 * rnd((Yb, Xb))
    lay = rnd((nz, 8, Yb, Xb), lo=0.5)
    lay[:, 6:] *= 0.1
    mkw = dict(has_mask=False, lay=lay.reshape(8 * nz, Yb, Xb), has_lap=True,
               has_drag=True, acc=(rnd((B * nz, Yb, Xb), 0.5), rnd((B * nz, Yb, Xb), 0.5)),
               mask_out=(mu, mv))

    def mom_one(m):
        layers = slice(m * nz, (m + 1) * nz)
        return momentum.momentum(ul[layers], vl[layers], st8, **dict(
            mkw, acc=tuple(a[layers] for a in mkw["acc"])))

    cases["momentum_members"] = dict(
        run=lambda: momentum.momentum(ul, vl, st8, period=nz, **mkw), one=mom_one,
        part=lambda m: slice(m * nz, (m + 1) * nz),
        plain=lambda: momentum.momentum_plain(ul, vl, st8, period=nz, **mkw), I=R_mom)
    pack = (mu[:, None] * rnd((nz, 4, Yb, Xb), lo=0.5)).reshape(4 * nz, Yb, Xb)
    g2 = rnd((2, Yb, Xb), lo=0.5)
    dz = torch.as_tensor(dzs, dtype=dtype, device="cuda")
    acc = rnd((B, 2 * nz + 2, Yb, Xb), 0.5)[:, :2 * nz]
    cases["tracer_adv_layered_members"] = dict(
        run=lambda: tracer_adv.tracer_adv(c, u, v, pack, g2, dz, acc=acc),
        one=lambda m: tracer_adv.tracer_adv(c[m], u[m], v[m], pack, g2, dz, acc=acc[m]),
        part=lambda m: m,
        plain=lambda: tracer_adv.tracer_adv_plain(c, u, v, pack, g2, dz, acc=acc), I=R_adv)
    if bulk:
        stacks = [rnd((B, nz, Yb, Xb)) for _ in range(6)]
        tracers = [rnd((B, 2 * nz, Yb, Xb)) for _ in range(3)]
        dz3 = dz.view(-1, 1, 1)
        d = 22 - 5
        ext = rnd((2, B, Yb + 2 * d, Xb + 2 * d))
        w1 = torch.tensor([1.0] + [1.6] * (B - 1), dtype=dtype, device="cuda")
        w2 = torch.tensor([0.0] + [0.6] * (B - 1), dtype=dtype, device="cuda")
        step_dt = torch.tensor(40.0, dtype=dtype, device="cuda")
        shared = (dz3 * mu, dz3 * mv, mc, rnd((Yb, Xb), lo=0.0), rnd((Yb, Xb), lo=0.0))
        crops = (ext[0, :, d:d + Yb, d:d + Xb], ext[1, :, d:d + Yb, d:d + Xb])
        cases["corrector_members"] = dict(
            run=lambda: corrector.corrector(*stacks, *tracers, *shared, *crops, w1, w2,
                                            step_dt),
            one=lambda m: corrector.corrector(*(a[m] for a in stacks + tracers), *shared,
                                              crops[0][m], crops[1][m], w1[m], w2[m],
                                              step_dt),
            part=lambda m: m,
            plain=lambda: corrector.corrector_plain(*stacks, *tracers, *shared, *crops, w1,
                                                    w2, step_dt),
            I=(slice(None), slice(None)))
    return cases


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("plane", [(40, 146), (15, 146), (60, 15), (12, 90)])
def test_cuda_member_launches_at_shard_and_strip_shapes(dtype, plane):
    """The member launches of a sharded ensemble (``_member_cases``) on a rank's plane
    and on the split's strips of 3·H rows or columns: 15 rows are fewer than one
    tracer tile, and 15 columns narrower than one tile of every kernel."""
    B, Yb, Xb = 3, *plane
    cases = _member_cases(_rnd(dtype, Yb * Xb), dtype, B, Yb, Xb, 4, bulk=min(plane) > 15)
    for kname, case in cases.items():
        _hold_member_case(kname, case, B, dtype)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_barotropic_members_on_a_rank(dtype):
    """The barotropic member axis on a rank's extended (66, 90) plane (halo 22, 21
    SM05 weights, the wrap off as the sharded steps run it, ``Nx`` the rank's 46
    columns)."""
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)

    B, Ye, Xe, Nx = 3, 66, 90, 46
    rnd = _rnd(dtype, 22)
    static = rnd((9, Ye, Xe), lo=0.5)
    static[7:] = (static[7:] > 0.6).to(dtype)
    dyn = [rnd((B, Ye, Xe), 0.01) for _ in range(3)] + [rnd((B, Ye, Xe), 1e-3)
                                                        for _ in range(2)]
    tail = (torch.tensor(0.01, dtype=dtype, device="cuda"),
            torch.as_tensor(averaging_weights(30)[1], dtype=dtype, device="cuda"))
    case = dict(
        run=lambda: barotropic.barotropic_substeps(static, *dyn, *tail, Nx, 22, False),
        one=lambda m: barotropic.barotropic_substeps(static, *(x[m] for x in dyn), *tail,
                                                     Nx, 22, False),
        part=lambda m: m,
        plain=lambda: barotropic.barotropic_substeps_plain(static, *dyn, *tail, Nx, 22,
                                                           False),
        I=(slice(22, Ye - 22), slice(22, Xe - 22)))
    _hold_member_case("barotropic", case, B, dtype)


def _forcing_c(lam, phi, t, fields):
    return 1e-7 * torch.sin(2e-4 * t) * torch.cos(torch.deg2rad(phi))


def _forcing_T(lam, phi, z, t, fields):
    return 1e-7 * torch.sin(2e-4 * t) * torch.cos(torch.deg2rad(phi))


def _sharded(model, state, mesh_kind, layered, overlap=None, fold_mode="auto"):
    """(step function, the ranks' states, gather) of ``state`` (one state or an
    ensemble's batch) on ``mesh_kind`` ranks through LocalExchange: a number of
    y-shards or an (n_x, n_y) mesh of blocks (its fold by ``fold_mode``)."""
    from orthogonalsphericalshellgrids_tpu_torch import parallel as P

    if isinstance(mesh_kind, int):
        mesh, extra, kw, arg = P.make_mesh(mesh_kind), (), {}, mesh_kind
        distribute, step_fn, gather = (
            (P.distribute_layered, P.sharded_layered_step_fn, P.gather_layered_state)
            if layered else (P.distribute, P.sharded_step_fn, P.gather_state))
    else:
        mesh = P.make_mesh2d(*mesh_kind)
        extra, kw, arg = (model.grid.Nx,), dict(fold_mode=fold_mode), mesh
        distribute, step_fn, gather = (
            (P.distribute_layered2d, P.sharded_layered_step_fn2d, P.gather_layered_state2d)
            if layered else (P.distribute2d, P.sharded_step_fn2d, P.gather_state2d))
    dm, ds = distribute(model, state, mesh)
    fn = step_fn(mesh, dm, *extra, overlap=overlap, **kw)
    return fn, ds, lambda s: gather(s, model, arg)


def _rank_launches(kind, layered, n_steps, split):
    """The launches of one rank of a sharded ensemble in ``n_steps`` steps: a y-shard
    (``kind`` 1) or a block of a 2-D mesh (2), with the split the tendency kernels on
    the bulk and on two strips a direction, the member launches in place of the
    one-member ones."""
    tend = (("vertical_members", "momentum_members", "tracer_adv_layered_members")
            if layered else ("momentum", "tracer_adv_members"))
    once = ("barotropic", "corrector_members") if layered else ("barotropic",)
    passes = 1 + 2 * kind if split else 1
    want = {k: n_steps * passes for k in tend}
    want.update({k: n_steps for k in once}, halo_restore=n_steps)
    if kind == 1:
        want.update(halo_pack=2 * n_steps, halo_fill_shard=2 * n_steps,
                    halo_wrap=n_steps if split else 0)
    else:
        want.update(halo_pack_block=4 * n_steps, halo_fill_block=4 * n_steps)
    return {k: n for k, n in want.items() if n}


@needs_cuda
@pytest.mark.parametrize("mesh_kind,overlap", [(4, None), ((2, 2), None), (4, False)],
                         ids=["y4", "2x2", "y4_unsplit"])
@pytest.mark.parametrize("which", ["bickley", "bickley_forcing", "gyre", "gyre_forcing"])
def test_cuda_sharded_ensemble_step_bitwise(which, mesh_kind, overlap):
    """Three members (the second one step ahead) of a float64 model on 4 y-shards and
    on 2 x 2 blocks through LocalExchange on the card, the split on (and unsplit on 4
    y-shards), 3 steps: every field of every member bitwise its own sharded run; each
    rank launches the member kernels as often as one member's rank launches the
    one-member kernels, and the steps make no host synchronization. The forcing (of
    c, of T) reads each member's time."""
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    layered = which.startswith("gyre")
    if which == "gyre_forcing":
        from examples.wind_driven_ts_gyre_torch import (CHECK_INIT, CHECK_OPTIONS,
                                                        build_check, check_bottom)
        from orthogonalsphericalshellgrids_tpu_torch.models import (
            SplitExplicitFreeSurface, layered_initial_state, make_layered_model)

        model = make_layered_model(build_check(device="cuda")[0].grid,
                                   free_surface=SplitExplicitFreeSurface(substeps=6),
                                   bottom_height=check_bottom, device="cuda",
                                   forcing={"T": _forcing_T}, **CHECK_OPTIONS)
        base = layered_initial_state(model, **CHECK_INIT)
    elif layered:
        from examples.wind_driven_ts_gyre_torch import build_check

        model, base = build_check(device="cuda")
    else:
        from examples.bickley_jet_torch import build

        kw = dict(forcing={"c": _forcing_c}) if which == "bickley_forcing" else {}
        model, base = build(48, 40, dtype=torch.float64, substeps=12, device="cuda", **kw)
    step = TL.layered_step if layered else TH.step
    serial = [_scaled(base, s) for s in (0.5, 1.0, 1.5)]
    serial[1] = step(model, serial[1], 60.0)
    fn, ds, gather = _sharded(model, ensemble.stack_members(serial), mesh_kind, layered,
                              overlap)
    fn(ds, 60.0)  # loads the kernels
    fn.launches = [dict.fromkeys(kernels.LAUNCHES, 0) for _ in fn.launches]
    with host_syncs() as n_syncs:
        for _ in range(3):
            ds = fn(ds, 60.0)
        syncs = n_syncs()
    fn.close()
    assert syncs == 0
    kind = 1 if isinstance(mesh_kind, int) else 2
    want = _rank_launches(kind, layered, 3, split=overlap is None)
    for own in fn.launches:
        assert {k: n for k, n in own.items() if n} == want, own
    got = gather(ds)
    for i, s in enumerate(serial):
        fn1, d1, gather1 = _sharded(model, s, mesh_kind, layered, overlap)
        for _ in range(3):
            d1 = fn1(d1, 60.0)
        fn1.close()
        want = gather1(d1)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(ensemble.member(got, i), f.name),
                               getattr(want, f.name)), (i, f.name)


# ------------------------------------------------------------------------------------
# checkpoint directories (torch.distributed.checkpoint) of states on the card
# ------------------------------------------------------------------------------------

def _assert_back_on_card(back, want):
    for f in dataclasses.fields(want):
        x, y = getattr(back, f.name), getattr(want, f.name)
        assert x.is_cuda and x.dtype == y.dtype, (f.name, x.device, x.dtype)
        assert torch.equal(x, y), f.name


def _zeroed(state):
    """A state of ``state``'s class with every field zeros like its own."""
    return type(state)(**{f.name: torch.zeros_like(getattr(state, f.name))
                          for f in dataclasses.fields(state)})


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_directory_checkpoint_serial_ensemble(tmp_path, dtype):
    """A 3-member ensemble of the 48 x 32 x 3 check gyre, one step on, written to a
    checkpoint directory and read into zeroed card tensors: every field bitwise, on
    the card, in its dtype."""
    from examples.wind_driven_ts_gyre_torch import build_check
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        load_checkpoint, save_checkpoint)

    model, base = build_check(dtype=dtype, device="cuda")
    batch = TL.layered_step(model, ensemble.stack_members(
        [_scaled(base, s) for s in (0.5, 1.0, 1.5)]), 60.0)
    path = str(tmp_path / "ck")
    save_checkpoint(path, batch)
    _assert_back_on_card(load_checkpoint(path, _zeroed(batch)), batch)


@needs_cuda
@pytest.mark.parametrize("mesh_kind", [4, (2, 2)], ids=["y4", "2x2"])
def test_cuda_directory_checkpoint_sharded_ensemble(tmp_path, mesh_kind):
    """Three members of the 48 x 40 float64 jet on 4 y-shards and on 2 x 2 blocks
    through LocalExchange on the card: one checkpoint directory read into zeroed rank
    states, every field of every rank bitwise, on the card, in its dtype, and a step
    on from it bitwise."""
    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        load_sharded_checkpoint, save_sharded_checkpoint)

    model, base = build(48, 40, dtype=torch.float64, substeps=12, device="cuda")
    batch = ensemble.stack_members([_scaled(base, s) for s in (0.5, 1.0, 1.5)])
    fn, ds, _ = _sharded(model, batch, mesh_kind, False)
    ds = fn(ds, 60.0)
    path = str(tmp_path / "ck")
    save_sharded_checkpoint(path, ds, fn.models)
    back = load_sharded_checkpoint(path, [_zeroed(s) for s in ds], fn.models)
    for a, b in zip(back, ds):
        _assert_back_on_card(a, b)
    for a, b in zip(fn(back, 60.0), fn(ds, 60.0)):
        _assert_back_on_card(a, b)
    fn.close()


@needs_cuda
@pytest.mark.parametrize("npz", [True, False], ids=["npz", "directory"])
def test_cuda_simulation_resumes_from_a_checkpoint_bitwise(tmp_path, npz):
    """The 48 x 32 x 3 check gyre through ``Simulation`` on the graphs to iteration 12,
    with a ``Checkpointer`` (an npz file or a directory) every 6 and T, S and u of the
    top layer written every 4 by the overlapped ``OutputWriter``: each step launches
    one step's kernels and makes no host synchronization at an iteration where no
    callback fires. A second run picked up from the checkpoint at 6 ends bitwise the
    first in every field, on the card, and writes the snapshots of 8 and 12 bitwise
    the first run's."""
    from examples.wind_driven_ts_gyre_torch import build_check
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        Checkpointer, FieldTimeSeries, IterationInterval, OutputWriter, Simulation)
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    model, state = build_check(device="cuda")
    TL.layered_multi_step(model, state, 60.0, 1)  # captures the block
    nz = model.nz
    surface = {"T": lambda s: s.state.c[0], "S": lambda s: s.state.c[nz],
               "u": lambda s: s.state.u[0]}
    ckpt = Checkpointer(str(tmp_path / "gyre"), npz=npz)
    ends, paths = {}, {}
    for run in ("once", "resumed"):
        paths[run] = str(tmp_path / f"surface_{run}.npz")
        sim = Simulation(model, state, dt=60.0, stop_iteration=12)
        sim.add_callback(OutputWriter(paths[run], surface), IterationInterval(4))
        if run == "once":
            sim.add_callback(ckpt, IterationInterval(6))
            marks = []
            kernels.reset_launch_counts()
            with host_syncs() as n_syncs:
                sim.add_callback(lambda s: marks.append((s.iteration, n_syncs())),
                                 IterationInterval(1))
                ends[run] = sim.run()
            counts = kernels.launch_counts()
        else:
            ends[run] = sim.run(pickup=ckpt.path_for(6))
        assert sim.iteration == 12, run
    syncs = {it: n - prev for (_, prev), (it, n) in zip(marks, marks[1:])}
    assert all(syncs[it] == 0 for it in (2, 3, 5, 7, 9, 10, 11)), syncs
    want = {k: 0 for k in kernels.LAUNCHES}
    want.update(halo_fill=24, halo_restore=12, barotropic=12, vertical=12,
                momentum_closures=12, tracer_adv_kappa=12, corrector=12)
    assert counts == want
    assert Checkpointer.latest(ckpt.prefix) == ckpt.path_for(12)
    _assert_back_on_card(ends["resumed"], ends["once"])
    for k in surface:
        once, resumed = (FieldTimeSeries(paths[r], k) for r in ("once", "resumed"))
        assert len(once) == 3 and len(resumed) == 2, k
        assert (resumed.data == once.data[1:]).all(), k
        assert (resumed.times == once.times[1:]).all(), k


@needs_cuda
@pytest.mark.parametrize("members", [1, 2])
def test_cuda_one_rank_nccl_group(tmp_path, members, monkeypatch):
    """The 48 x 40 float64 jet, one state or 2 members (the second one step ahead),
    through the sharded step of a 1-rank NCCL process group (``ProcessGroupExchange``;
    with one rank the step takes the serial route and makes no NCCL operation): 3
    steps bitwise the serial ones, with the serial launches and no host
    synchronization. The 2 members are written to a checkpoint directory over the
    group (one rank's file), read back over it into zeroed card tensors bitwise, and
    stepped on from it bitwise."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import parallel
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        load_sharded_checkpoint, save_sharded_checkpoint)
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    model, state = build(48, 40, dtype=torch.float64, substeps=12, device="cuda")
    if members > 1:
        state = ensemble.stack_members([state, TH.step(model, _scaled(state, 0.5), 60.0)])
    want = ensemble.ensemble_multi_step(model, state, 60.0, 4) if members > 1 else \
        TH.multi_step(model, state, 60.0, 4)
    loads = []
    load = dcp.load
    monkeypatch.setattr(dcp, "load", lambda sd, **kw: (
        loads.append(kw.get("no_dist", False)), load(sd, **kw))[1])
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + str(tmp_path / "store"),
                            rank=0, world_size=1)
    try:
        mesh = parallel.ProcessGroupExchange()
        dm, ds = parallel.distribute(model, state, mesh)
        fn = parallel.sharded_step_fn(mesh, dm)
        s = fn(ds, 60.0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with host_syncs() as n_syncs:
            for _ in range(3):
                s = fn(s, 60.0)
            syncs = n_syncs()
        counts = {k: n for k, n in kernels.launch_counts().items() if n}
        if members > 1:
            path = str(tmp_path / "ck")
            save_sharded_checkpoint(path, s, dm)
            files = sorted(os.listdir(path))
            back = load_sharded_checkpoint(path, [_zeroed(s[0])], dm)
            _assert_back_on_card(back[0], s[0])
            _assert_back_on_card(fn(back, 60.0)[0], fn(s, 60.0)[0])
    finally:
        dist.destroy_process_group()
    assert syncs == 0
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(s[0], f.name), getattr(want, f.name)), f.name
    assert counts == {"halo_fill": 6, "halo_restore": 3, "barotropic": 3, "momentum": 3,
                      "tracer_adv_members" if members > 1 else "tracer_adv": 3}, counts
    if members > 1:
        assert files == [".metadata", "__0_0.distcp"], files
        assert loads == [True, False], loads  # the decomposition alone, then the group


# ------------------------------------------------------------------------------------
# the committed trajectory oracles through the kernels
# ------------------------------------------------------------------------------------

@needs_cuda
@pytest.mark.parametrize("which", ["bickley", "front", "front_member"])
def test_cuda_oracles_through_the_kernels(which):
    """The committed oracles of the JAX package at float64, with the tolerances of
    ``tests/test_parity.py``, through the kernels: 20 steps of the 180 x 90 Bickley
    jet (u, v, c, η at rtol 1e-9, atol 1e-12; kinetic energy, enstrophy and tracer
    variance at rtol 1e-10), 15 of the 120 x 60 x 4 baroclinic front (u, v, b at rtol
    1e-9, atol 1e-14; kinetic energy at rtol 1e-10), and the front as member 0 of a
    2-member ensemble whose member 1 is its state times 0.9 one step ahead, through
    the member launches."""
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble

    data = os.path.join(ROOT, "tests", "data")
    kernels.reset_launch_counts()
    if which == "bickley":
        from examples.bickley_jet_torch import build, diagnostics

        with np.load(os.path.join(data, "bickley_oracle_180x90.npz")) as d:
            nx, ny, dt, _, _ = d["meta"]
            ref = {k: d[k] for k in ("u.020", "v.020", "c.020", "eta.020")}
            curves = {k: d[k][:20] for k in ("ke", "ens", "cvar")}
        model, s = build(int(nx), int(ny), dtype=torch.float64, substeps=30, device="cuda")
        got = {k: [] for k in curves}
        for _ in range(20):
            s = TH.step(model, s, float(dt))
            for k, val in zip(("ke", "ens", "cvar"), diagnostics(model, s)):
                got[k].append(val)
        assert kernels.launch_counts()["barotropic"] == 20
        g = model.grid
        fields = {"u": g.interior(s.u), "v": g.interior(s.v), "c": g.interior(s.c),
                  "eta": model.grid_ext.interior(s.eta)}
        atol, n = 1e-12, 20
    else:
        from examples.baroclinic_front_torch import build, kinetic_energy

        with np.load(os.path.join(data, "front_oracle_120x60x4.npz")) as d:
            nx, ny, nz, dt, _, _ = d["meta"]
            ref = {k: d[k] for k in ("u.015", "v.015", "b.015")}
            curves = {"ke": d["ke"][:15]}
        model, s = build(int(nx), int(ny), int(nz), dtype=torch.float64, device="cuda")
        if which == "front_member":
            s = ensemble.stack_members(
                [s, TL.layered_step(model, _scaled(s, 0.9), float(dt))])
            kernels.reset_launch_counts()
        got = {"ke": []}
        for _ in range(15):
            s = TL.layered_step(model, s, float(dt))
            one = ensemble.member(s, 0) if which == "front_member" else s
            got["ke"].append(kinetic_energy(model, one))
        counts = kernels.launch_counts()
        if which == "front_member":
            assert int(s.iteration[0]) == 15 and int(s.iteration[1]) == 16
            assert all(counts[k] == 15 for k in ("vertical_members", "momentum_members",
                                                 "corrector_members", "barotropic"))
            assert counts["tracer_adv_layered_members"] == 30, counts
        else:
            assert all(counts[k] == 15 for k in ("vertical", "momentum_layered",
                                                 "barotropic")), counts
        fields = {k: model.grid.interior(getattr(one, k)) for k in ("u", "v", "b")}
        atol, n = 1e-14, 15
    for name, a in fields.items():
        np.testing.assert_allclose(a.cpu().numpy(), ref[f"{name}.{n:03d}"], rtol=1e-9,
                                   atol=atol, err_msg=name)
    for k, curve in curves.items():
        np.testing.assert_allclose(got[k], curve, rtol=1e-10, atol=0, err_msg=k)


# ------------------------------------------------------------------------------------
# the behaviour pins of tests/test_torch_behaviour.py, through the kernels
# ------------------------------------------------------------------------------------

@needs_cuda
def test_cuda_gravity_wave_speed():
    from test_torch_behaviour import gravity_wave_speed

    gravity_wave_speed("cuda")


@needs_cuda
def test_cuda_internal_gravity_wave_speed_two_layer():
    from test_torch_behaviour import internal_gravity_wave_speed_two_layer

    internal_gravity_wave_speed_two_layer("cuda")


@needs_cuda
def test_cuda_blob_crosses_fold():
    from test_torch_behaviour import blob_crosses_fold

    blob_crosses_fold("cuda")


# ------------------------------------------------------------------------------------
# the compiled blocks (utils/graph.py): the captured CUDA graphs of a step against the
# eager loop of the step
# ------------------------------------------------------------------------------------

def _graph_case(path, dtype):
    """(block function, step function, model, state) of a small path on the card: the
    48 x 40 jet (substeps 12), the 48 x 32 x 3 check gyre, or either as 4 members
    (the state times 0.5, 0.75, 1.0 and 1.25)."""
    from orthogonalsphericalshellgrids_tpu_torch.models import ensemble

    if path.startswith("gyre"):
        from examples.wind_driven_ts_gyre_torch import build_check

        model, state = build_check(dtype=dtype, device="cuda")
        block, step = TL.layered_multi_step, TL.layered_step
    else:
        from examples.bickley_jet_torch import build

        model, state = build(48, 40, dtype=dtype, substeps=12, device="cuda")
        block, step = TH.multi_step, TH.step
    if not path.endswith("_ensemble"):
        return block, step, model, state
    members = [_scaled(state, s) for s in (0.5, 0.75, 1.0, 1.25)]
    return ensemble.ensemble_multi_step, step, model, ensemble.stack_members(members)


def _eager(step, model, state, dt, n):
    for _ in range(n):
        state = step(model, state, dt)
    return state


def _states_equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["bickley", "gyre", "bickley_ensemble", "gyre_ensemble"])
def test_cuda_graph_block_is_the_eager_loop(path, dtype):
    """Blocks of 1, 2, 3 and 7 steps replayed from their captured graphs are bitwise
    the eager loop of the step from the same state; the input is left as it was, and
    the result shares no storage with the input or with the graphs' buffers."""
    from orthogonalsphericalshellgrids_tpu_torch.utils import graph

    block, step, model, state = _graph_case(path, dtype)
    before = {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}
    for n in (1, 2, 3, 7, 3):
        got = block(model, state, 60.0, n)
        want = _eager(step, model, state, 60.0, n)
        torch.cuda.synchronize()
        assert _states_equal(got, want), n
        assert all(torch.equal(getattr(state, k), v) for k, v in before.items())
        buffers = graph.blocks(model)[graph.layout(step, state)].buffers
        for f in dataclasses.fields(got):
            ptr = getattr(got, f.name).untyped_storage().data_ptr()
            assert ptr != getattr(state, f.name).untyped_storage().data_ptr()
            assert all(ptr != getattr(b, f.name).untyped_storage().data_ptr()
                       for b in buffers)


@needs_cuda
@pytest.mark.parametrize("path", ["bickley", "gyre", "bickley_ensemble", "gyre_ensemble"])
def test_cuda_graph_replay_counts_launches_and_never_waits(path):
    """After the capture, a replayed block of 3 steps (and of 5: odd n) counts the
    launches of 3 (5) eager steps, n times the captured step's record, and makes no
    host synchronization; a dt changed between replays (a number, then a 0-d tensor on the
    card) reaches the graph, each block bitwise the eager loop at that dt."""
    from orthogonalsphericalshellgrids_tpu_torch.utils import graph
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import host_syncs

    block, step, model, state = _graph_case(path, torch.float32)
    for n in (3, 5):
        block(model, state, 60.0, n)  # captures the block
        kernels.reset_launch_counts()
        want = _eager(step, model, state, 60.0, n)
        eager_counts = kernels.launch_counts()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        with host_syncs() as n_syncs:
            got = block(model, state, 60.0, n)
            waits = n_syncs()
        assert waits == 0
        assert kernels.launch_counts() == eager_counts
        recorded = graph.blocks(model)[graph.layout(step, state)].launches
        assert {k: n * v for k, v in recorded.items()} == eager_counts
        assert _states_equal(got, want)
    for dt in (45.0, torch.tensor(30.0, device="cuda"), 60.0):
        with host_syncs() as n_syncs:
            got = block(model, state, dt, 3)
            waits = n_syncs()
        assert waits == 0
        assert _states_equal(got, _eager(step, model, state, dt, 3)), dt


@needs_cuda
def test_cuda_simulation_keeps_its_state_in_the_graphs():
    """Through ``Simulation`` the state stays in the graphs' buffers between steps.
    Eight steps with a callback that reads the state (iteration 2), one that halves c
    in place (iteration 4) and one that runs a block of the same model from another
    state (iteration 6) are bitwise the eager loop with c halved after step 4."""
    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch.utils import IterationInterval, Simulation

    model, state = build(48, 40, dtype=torch.float64, substeps=12, device="cuda")

    def callback(sim):
        if sim.iteration == 2:
            float(sim.state.u.sum())
        if sim.iteration == 4:
            sim.state.c.mul_(0.5)
        if sim.iteration == 6:
            TH.multi_step(model, state, 30.0, 2)

    sim = Simulation(model, state, dt=60.0, stop_iteration=8, nan_checker=False)
    sim.add_callback(callback, IterationInterval(1))
    got = sim.run()
    want = state
    for it in range(1, 9):
        want = TH.step(model, want, 60.0)
        if it == 4:
            want = dataclasses.replace(want, c=want.c * 0.5)
    torch.cuda.synchronize()
    assert _states_equal(got, want)


@needs_cuda
def test_cuda_graph_capture_failure_raises():
    """A step that waits for the card (a forcing that reads the time on the host) runs
    eagerly but cannot be captured: the block raises and keeps no graph, and nothing
    falls back to the eager loop."""
    from orthogonalsphericalshellgrids_tpu_torch.utils import graph

    block, step, model, state = _graph_case("bickley", torch.float64)

    def reads_t(lam, phi, t, fields):
        return 0.0 * fields.u + 0.0 * float(t)

    model.forcing = (("u", reads_t),)
    _eager(step, model, state, 60.0, 2)
    with pytest.raises(RuntimeError):
        block(model, state, 60.0, 2)
    torch.cuda.synchronize()
    assert graph.blocks(model)[graph.layout(step, state)].graphs is None


# ------------------------------------------------------------------------------------
# the options of the benchmark's OM4p25 configuration (perfbench/configs/om4p25_l75.json:
# T and S, implicit vertical mixing) on a 48 x 40 plane
# ------------------------------------------------------------------------------------

def _om4_case(nz):
    """(configuration, inputs, model, state) of the OM4p25 options at 48 x 40 x ``nz``
    in float32 on the card, from the scenario's seeded fields."""
    import json

    from perfbench.lib import program, scenario

    with open(os.path.join(ROOT, "perfbench", "configs", "om4p25_l75.json")) as f:
        cfg = json.load(f)
    cfg.update(nx=48, ny=40, nz=nz)
    inp = scenario.inputs(cfg, 2 ** 33 + 19)
    model, state = program.build(cfg, inp, "cuda")
    return cfg, inp, model, state


@needs_cuda
def test_cuda_om4_block_at_75_levels_is_the_eager_loop_and_the_reference():
    """Three steps at Nz = 75 with implicit vertical mixing (the vertical kernel's
    chunks of interfaces, the plain solve inside the graphs): the replayed block is
    bitwise the eager loop of ``layered_step``, and within 1e-4 of each field's
    largest value of the float64 reference (``perfbench/reference/layered.py``) at
    the interior points; float32 on the CPU reads 1.4e-5 after three steps of 300 s (η)."""
    from perfbench.reference import layered as ref

    cfg, inp, model, state = _om4_case(75)
    TL.layered_multi_step(model, state, cfg["dt"], 3)  # captures the block
    got = TL.layered_multi_step(model, state, cfg["dt"], 3)
    want = _eager(TL.layered_step, model, state, cfg["dt"], 3)
    torch.cuda.synchronize()
    assert _states_equal(got, want)
    m = ref.build(cfg, inp, dtype=torch.float64, device="cuda", sample_dtype=torch.float32)
    s = ref.run(m, ref.initial_state(m, inp["init"]), cfg["dt"], 3)
    for name in ("u", "v", "eta", "U", "V", "c"):
        h = m["He"] if name in ("eta", "U", "V") else m["H"]
        g, r = (a[..., h:-h, h:-h].double() for a in (getattr(got, name), s[name]))
        assert float((g - r).abs().max() / r.abs().max()) < 1e-4, name
