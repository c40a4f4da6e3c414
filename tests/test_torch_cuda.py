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
        assert (g[:R] == 0).all() and (g[:, -R:] == 0).all()


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
