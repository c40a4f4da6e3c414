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


def _fill_group(path, dtype):
    """The fill group of a path at small geometry, on the card: the state's fields
    on 48 x 40 planes at halo 5, and η, U, V as views of one (3, Ye, Xe) buffer at
    halo 22; ``odd``: three fields on planes no block of 256 threads divides."""
    r = np.random.default_rng(len(path))

    def cu(shape):
        return torch.as_tensor(r.standard_normal(shape), dtype=dtype, device="cuda")

    if path == "odd":
        return [(cu((3, 13 + 2 * 3, 18 + 2 * 4)), FC, -1, 18, 13, 4, 3),
                (cu((14 + 2 * 2, 22 + 2 * 3)), CF, -1, 22, 14, 3, 2),
                (cu((2, 9 + 2 * 1, 10 + 2 * 2)), FF, 1, 10, 9, 2, 1)]
    stacks = {"bickley": [(None, FC, -1), (None, CF, -1), (None, CC, 1)],
              "front": [(3, FC, -1), (3, CF, -1), (3, CC, 1), (3, CC, 1)],
              "gyre": [(3, FC, -1), (3, CF, -1), (6, CC, 1)]}[path]
    fields = [(cu((50, 58) if K is None else (K, 50, 58)), loc, s, 48, 40, 5, 5)
              for K, loc, s in stacks]
    ext = cu((3, 84, 92))
    return fields + [(ext[0], CC, 1, 48, 40, 22, 22), (ext[1], FC, -1, 48, 40, 22, 22),
                     (ext[2], CF, -1, 48, 40, 22, 22)]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["bickley", "front", "gyre", "odd"])
def test_cuda_group_fill_and_restore_bitwise(dtype, path):
    """One launch fills the group, with and without the save, bitwise the plain
    version's fields and strips; one launch restores every field bitwise."""
    fields = _fill_group(path, dtype)
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
    block or strip offset is refused at launch, and nothing is written."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import call

    fields = _fill_group("front", torch.float32)
    before = [f[0].clone() for f in fields]
    geoms, _ = halo_fill._group("t", fields)
    plan = halo_fill.group_plan(geoms)
    saved = torch.empty(plan.n_saved, device="cuda")
    for col in (11, 12, 13):  # cells, first block, first strip offset of field 1
        table = halo_fill._table(fields, geoms)
        table[14 + col] += 1
        with pytest.raises(RuntimeError):
            call("osg_halo_fill_group", torch.float32, saved.device, table, len(fields),
                 saved.data_ptr(), 1)
        with pytest.raises(RuntimeError):
            call("osg_halo_restore_group", torch.float32, saved.device, table,
                 len(fields), saved.data_ptr())
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
    want.update(halo_fill=10, halo_restore=5, barotropic=5, momentum=5, tracer_adv=5)
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
    """One launch against the plain version on the mask pack built from the same
    wet-layer counts (drawn from 0 to Nz a column), on a plane no tile divides."""
    _vertical_case(dtype, mode, nz, mixing, 2 if mode == "linear_eos" else 1)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode,n_c", [("tracer_b", 2), ("linear_eos", 3), ("none", 4)])
def test_cuda_vertical_more_tracers(dtype, mode, n_c):
    """Three and four tracer blocks: the kernel carries the first two in registers and
    reads the others at each layer."""
    _vertical_case(dtype, mode, 6, True, n_c)


def _vertical_case(dtype, mode, nz, mixing, n_c):
    r = np.random.default_rng(nz)
    Yb, Xb = 40, 52
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
    assert _edge_zero(got, R)


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
    want.update(halo_fill=6, halo_restore=3, barotropic=3, vertical=3,
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
