#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: build, kernels, main path, parity.

    python3 chip_smoke.py

Phase 0  the card (nvidia-smi name and power limit), torch and CUDA versions; exits
         non-zero when no CUDA card is available.
Phase 1  builds the CUDA kernels from csrc/ with nvcc (sm_90a).
Phase 2  each kernel against its plain PyTorch version on the card, on seeded random
         inputs at the main path's shapes, at float32 and float64 (both fills
         bitwise, the others within the bands of tests/test_torch_cuda.py), with median
         kernel and plain times from CUDA events.
Phase 3  the main path: the Bickley jet on the 1/4-degree tripolar grid (1440 x 680,
         halo 5, float32, substeps=30), 20 steps at dt = 60 s through multi_step;
         checks the launch counts, finite fields and the tracer range; ms/step.
Phase 4  parity on the card: the 180 x 90 float64 Bickley jet, 20 steps through the
         kernels, against tests/data/bickley_oracle_180x90.npz with the tolerances
         of tests/test_parity.py.
Phase 5  the layered path: the baroclinic front on the 1/4-degree tripolar grid with
         10 layers (1440 x 680 x 10, float32, substeps=30), 10 steps at dt = 40 s
         after 3 warm-up steps through layered_multi_step; checks the launch counts
         per step and finite fields; ms/step and G grid-points/s.
Phase 6  layered parity on the card: the 120 x 60 x 4 float64 front, 15 steps
         through the kernels, against tests/data/front_oracle_120x60x4.npz with the
         tolerances of tests/test_parity.py:233-236.
Phase 7  the gyre: the wind-driven T/S gyre of bench_layered.py (1440 x 680 x 10,
         stretched layers, T and S with the linear EOS, Coriolis, wind, quadratic
         drag, nu_h = 5e3, kappa_h = 1e2, nu_v = 1e-3, kappa_v = 1e-5, float32,
         substeps=30), 10 steps at dt = 40 s after 3 warm-up steps; checks the launch
         counts per step and finite fields; ms/step and G grid-points/s.
Phase 8  gyre parity on the card: 3 float64 steps of the 48 x 32 x 3 check gyre
         (examples/wind_driven_ts_gyre_torch.py:build_check) through the kernels
         against the port's plain path on the CPU, rtol 1e-11.

Phase 2 also holds the layered kernels against their plain versions: the vertical
column kernel at (10, 690, 1450) in its three modes and at Nz = 50, the layered
momentum kernel at Nz = 10, the layered tracer kernel with 1 and 2 tracers, and the
halo fill on a 10-plane stack; and the gyre's modes: momentum with the nu_h and drag
planes on one layer and on 10, tracer advection with kappa_h in column and layered
mode, and the corrector with and without b.

Prints the kernel table as one JSON line (with each kernel's bound: the larger of
its bytes, every input read once and every output written once, over 3.35 TB/s and
its operations over 67 TFLOP/s at float32), then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Any failed check raises, and the
script exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FILL_SHAPES = {"base": (690, 1450), "ext": (724, 1484)}
BANDS = {"float32": 1e-5, "float64": 1e-12}
REPLACES = {
    "halo_fill": "orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:238",
    "halo_fill_copy": "orthogonalsphericalshellgrids_tpu/ops/pallas_fill.py:292",
    "barotropic": "orthogonalsphericalshellgrids_tpu/ops/pallas_baro.py:242",
    "momentum": "orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:281",
    "tracer_adv": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    "vertical": "orthogonalsphericalshellgrids_tpu/ops/pallas_vert.py:309",
    "momentum_layered": "orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:281",
    "tracer_adv_layered": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    "momentum_closures": "orthogonalsphericalshellgrids_tpu/ops/pallas_mom.py:281",
    "tracer_adv_kappa": "orthogonalsphericalshellgrids_tpu/ops/pallas_adv.py:258",
    "corrector": "orthogonalsphericalshellgrids_tpu/ops/pallas_corr.py:83",
}
SOURCE_FILE = {"halo_fill_copy": "halo_fill", "momentum_layered": "momentum",
               "tracer_adv_layered": "tracer_adv", "momentum_closures": "momentum",
               "tracer_adv_kappa": "tracer_adv"}
SOURCES = {name: "orthogonalsphericalshellgrids_tpu_torch/csrc/{}.cu".format(
    SOURCE_FILE.get(name, name)) for name in REPLACES}
# the kernels each main path must launch: the Bickley jet (phase 3), the baroclinic
# front (phase 5) and the gyre (phase 7)
BICKLEY = ("halo_fill", "halo_fill_copy", "barotropic", "momentum", "tracer_adv")
FRONT = ("halo_fill", "halo_fill_copy", "barotropic", "vertical", "momentum_layered",
         "tracer_adv_layered", "corrector")
GYRE = ("halo_fill", "halo_fill_copy", "barotropic", "vertical", "momentum_closures",
        "tracer_adv_kappa", "corrector")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n=20, reps=5, warm=3):
    """Milliseconds per call: CUDA events around ``n`` back-to-back calls, median of
    ``reps`` such windows, after ``warm`` calls. A call whose host-side enqueue takes
    longer than its device work (a small kernel) is timed at the enqueue rate."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    times.sort()
    return times[len(times) // 2]


def rel_err(got, want, sl):
    g, w = got[..., sl[0], sl[1]], want[..., sl[0], sl[1]]
    return float((g - w).abs().max()), float((g - w).abs().max() / w.abs().max())


def nbytes(*tensors):
    """Bytes of the tensors (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops):
    """(least ms the card could take, what bounds it): the larger of the bytes over
    the HBM rate and the operations over the float32 rate."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# operations per output value, counted from each kernel's arithmetic: the fill's
# sign; per substep and cell the barotropic pair's divergence, gradients and
# updates; momentum's vorticity, two WENO-5 reconstructions and KE gradient (+40
# with the closure planes); tracer advection's four face reconstructions (+12 with
# kappa_h); the vertical pass per layer and tracer block; the corrector's AB2 update
FLOPS = {"halo_fill": 1, "halo_fill_copy": 1, "barotropic": 30, "momentum": 300,
         "momentum_layered": 300, "momentum_closures": 340, "tracer_adv": 300,
         "tracer_adv_layered": 300, "tracer_adv_kappa": 312, "vertical": 40,
         "corrector": 8}


def phase2_kernels(card):
    """Each kernel against its plain version at the main path's shapes; returns
    {name: (max_abs_err at float32, kernel ms, plain ms)}."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import (barotropic, halo_fill,
                                                                 momentum, tracer_adv)
    from orthogonalsphericalshellgrids_tpu_torch.models.split_explicit import (
        averaging_weights)
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    results = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(2024)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        # halo fill: every (plane, location) of the main path, bitwise
        for plane, (Yb, Xb) in FILL_SHAPES.items():
            H = 5 if plane == "base" else 22
            Nx, Ny = Xb - 2 * H, Yb - 2 * H
            for loc, sign in ((CC, 1), (FC, -1), (CF, -1)):
                A = rnd((Yb, Xb))
                A0 = A.clone()
                want = halo_fill.fill_halos_plain(A.clone(), loc, sign, Nx, Ny, H, H)
                got = halo_fill.fill_halos(A.clone(), loc, sign, Nx, Ny, H, H)
                copy = halo_fill.fill_halos(A, loc, sign, Nx, Ny, H, H, inplace=False)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"fill {plane} {loc} {name} bitwise")
                check(torch.equal(copy, want) and torch.equal(A, A0),
                      f"out-of-place fill {plane} {loc} {name} bitwise, input kept")
        A = rnd(FILL_SHAPES["ext"])
        Nx, Ny = 1440, 680
        t_k = time_ms(lambda: halo_fill.fill_halos(A, FC, -1, Nx, Ny, 22, 22))
        t_p = time_ms(lambda: halo_fill.fill_halos_plain(A, FC, -1, Nx, Ny, 22, 22))
        t_kc = time_ms(lambda: halo_fill.fill_halos(A, FC, -1, Nx, Ny, 22, 22,
                                                    inplace=False))
        t_pc = time_ms(lambda: halo_fill.fill_halos_plain(A.clone(), FC, -1, Nx, Ny, 22,
                                                          22))
        log(f"phase 2: halo_fill {name}: in place and out of place bitwise equal on 6 "
            f"main-path planes; ext-plane (724, 1484) FC fill in place {t_k:.4f} ms "
            f"kernel, {t_p:.4f} ms plain; out of place {t_kc:.4f} ms kernel, "
            f"{t_pc:.4f} ms plain (clone + fill) [{card}]")
        if name == "float32":
            # in place: each halo cell read from its source and written; out of
            # place: the plane read and written
            n_halo = A.numel() - Nx * Ny
            results["halo_fill"] = (0.0, t_k, t_p, bound(2 * n_halo * A.element_size(),
                                                         FLOPS["halo_fill"] * n_halo))
            results["halo_fill_copy"] = (0.0, t_kc, t_pc, bound(
                2 * nbytes(A), FLOPS["halo_fill_copy"] * A.numel()))

        # barotropic subcycle on the extended plane, 21 SM05 weights
        Ye, Xe = FILL_SHAPES["ext"]
        static = rnd((9, Ye, Xe), lo=0.5)
        static[7:] = (static[7:] > 0.6).to(dt)  # masks
        eta, U, V = (rnd((Ye, Xe), 0.01) for _ in range(3))
        GU, GV = (rnd((Ye, Xe), 1e-3) for _ in range(2))
        dtau = torch.tensor(0.01, dtype=dt, device="cuda")
        weights = torch.as_tensor(averaging_weights(30)[1], dtype=dt, device="cuda")
        I = (slice(22, Ye - 22), slice(22, Xe - 22))
        errs = []
        for wrap in (False, True):
            args = (static, eta, U, V, GU, GV, dtau, weights, 1440, 22, wrap)
            for g, w in zip(barotropic.barotropic_substeps(*args),
                            barotropic.barotropic_substeps_plain(*args)):
                ea, er = rel_err(g, w, I)
                check(er <= BANDS[name] and bool(torch.isfinite(g).all()),
                      f"barotropic {name} wrap={wrap}: rel err {er:.3e}")
                errs.append((ea, er))
        args = (static, eta, U, V, GU, GV, dtau, weights, 1440, 22, False)
        t_k = time_ms(lambda: barotropic.barotropic_substeps(*args), n=10)
        t_p = time_ms(lambda: barotropic.barotropic_substeps_plain(*args), n=10)
        ea = max(e[0] for e in errs)
        log(f"phase 2: barotropic {name}: max abs err {ea:.3e}, max rel err "
            f"{max(e[1] for e in errs):.3e} (band {BANDS[name]:g}); 21 substeps on "
            f"(724, 1484) {t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
        if name == "float32":
            results["barotropic"] = (ea, t_k, t_p, bound(
                nbytes(static, eta, U, V, GU, GV) + 3 * nbytes(eta),
                FLOPS["barotropic"] * weights.numel() * eta.numel()))

        # momentum and tracer advection on the base plane
        Yb, Xb = FILL_SHAPES["base"]
        u, v = rnd((Yb, Xb)), rnd((Yb, Xb))
        st = rnd((10, Yb, Xb), lo=1.0)
        st[3] = 0.1 * rnd((Yb, Xb))
        st[8:] = (st[8:] > 1.15).to(dt)
        R = momentum.REACH
        I = (slice(R, -R), slice(R, -R))
        errs = [rel_err(g, w, I) for g, w in zip(momentum.momentum(u, v, st),
                                                  momentum.momentum_plain(u, v, st))]
        er = max(e[1] for e in errs)
        check(er <= BANDS[name], f"momentum {name}: rel err {er:.3e}")
        t_k = time_ms(lambda: momentum.momentum(u, v, st))
        t_p = time_ms(lambda: momentum.momentum_plain(u, v, st))
        ea = max(e[0] for e in errs)
        log(f"phase 2: momentum {name}: max abs err {ea:.3e}, max rel err {er:.3e} "
            f"(band {BANDS[name]:g}); (690, 1450) {t_k:.4f} ms kernel, {t_p:.4f} ms "
            f"plain [{card}]")
        if name == "float32":
            results["momentum"] = (ea, t_k, t_p, bound(
                nbytes(u, v, st) + 2 * nbytes(u), FLOPS["momentum"] * u.numel()))

        c = rnd((Yb, Xb))
        sa = rnd((5, Yb, Xb), lo=1.0)
        R = tracer_adv.REACH
        ea, er = rel_err(tracer_adv.tracer_adv(c, u, v, sa),
                         tracer_adv.tracer_adv_plain(c, u, v, sa),
                         (slice(R, -R), slice(R, -R)))
        check(er <= BANDS[name], f"tracer_adv {name}: rel err {er:.3e}")
        t_k = time_ms(lambda: tracer_adv.tracer_adv(c, u, v, sa))
        t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(c, u, v, sa))
        log(f"phase 2: tracer_adv {name}: max abs err {ea:.3e}, max rel err {er:.3e} "
            f"(band {BANDS[name]:g}); (690, 1450) {t_k:.4f} ms kernel, {t_p:.4f} ms "
            f"plain [{card}]")
        if name == "float32":
            results["tracer_adv"] = (ea, t_k, t_p, bound(
                nbytes(c, u, v, sa) + nbytes(c), FLOPS["tracer_adv"] * c.numel()))
    return results


def phase2_layered(card):
    """The layered kernels against their plain versions at the front's shapes;
    returns {name: (max_abs_err at float32, kernel ms, plain ms)} for the front's
    own cases (vertical in tracer_b mode with c + b, S = 3; one tracer stack)."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import (halo_fill, momentum,
                                                                 tracer_adv, vertical)
    from orthogonalsphericalshellgrids_tpu_torch.ops.location import CC, CF, FC

    results = {}
    Yb, Xb = FILL_SHAPES["base"]
    eos = (9.81, 1.67e-4, 7.8e-4, 10.0, 35.0)
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(7)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        def masks(shape):
            return torch.as_tensor(rng.random(shape) > 0.15, dtype=dt, device="cuda")

        # the halo fill on a 10-plane stack, bitwise, in place and out of place
        for loc, sign in ((CC, 1), (FC, -1), (CF, -1)):
            A = rnd((10, Yb, Xb))
            A0 = A.clone()
            want = halo_fill.fill_halos_plain(A.clone(), loc, sign, 1440, 680, 5, 5)
            got = halo_fill.fill_halos(A.clone(), loc, sign, 1440, 680, 5, 5)
            copy = halo_fill.fill_halos(A, loc, sign, 1440, 680, 5, 5, inplace=False)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(copy, want) and torch.equal(A, A0),
                  f"10-plane fill {loc} {name} bitwise, input kept")
        t_k = time_ms(lambda: halo_fill.fill_halos(A, CC, 1, 1440, 680, 5, 5,
                                                   inplace=False))
        t_p = time_ms(lambda: halo_fill.fill_halos_plain(A.clone(), CC, 1, 1440, 680, 5, 5))
        log(f"phase 2: halo_fill {name} on (10, 690, 1450): bitwise in place and out "
            f"of place (CC, FC, CF); out of place {t_k:.4f} ms kernel, {t_p:.4f} ms "
            f"plain [{card}]")

        # the vertical column kernel: three modes at the front's shape, and Nz = 50
        cases = [("none", 10, (Yb, Xb), False, False),
                 ("tracer_b", 10, (Yb, Xb), True, True),
                 ("linear_eos", 10, (Yb, Xb), False, False),
                 ("tracer_b", 50, (200, 300), True, True)]
        for mode, nz, (ny, nx), mixing, front in cases:
            S = 3 if mixing else 1
            mu, mv = masks((nz, ny, nx)), masks((nz, ny, nx))
            u, v = rnd((nz, ny, nx)) * mu, rnd((nz, ny, nx)) * mv
            n_c = 2 if mode == "linear_eos" else 1
            c = rnd((n_c * nz, ny, nx))
            if mode == "linear_eos":
                c[:nz] += 10.0
                c[nz:] = 35.0 + 0.1 * c[nz:]
            b = rnd((nz, ny, nx)) if mode == "tracer_b" else None
            mc = masks((nz, ny, nx))
            sp = torch.stack([mc, mu, mv][:S], dim=1).reshape(S * nz, ny, nx).contiguous()
            g = rnd((5, ny, nx), lo=0.5)
            dzs = [100.0] * nz
            coef = torch.as_tensor(vertical.coefficients(
                dzs, dzs[1:], 1e-4 if mixing else 0.0, 1e-5 if mixing else 0.0),
                dtype=dt, device="cuda")
            kw = dict(mode=mode, eos=eos, it_T=0 if n_c == 2 else -1,
                      it_S=1 if n_c == 2 else -1, viscous=mixing, diffusive=mixing)
            args = (u, v, c, b, sp, g, coef)
            I = (slice(1, -1), slice(1, -1))
            errs = [rel_err(gk, wp, I) for gk, wp in zip(vertical.vertical(*args, **kw),
                                                         vertical.vertical_plain(*args, **kw))]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            check(er <= BANDS[name], f"vertical {mode} Nz={nz} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: vertical.vertical(*args, **kw))
            t_p = time_ms(lambda: vertical.vertical_plain(*args, **kw), n=3, reps=3)
            log(f"phase 2: vertical {mode} S={S} {name} on ({nz}, {ny}, {nx}) with "
                f"{n_c + (b is not None)} tracer blocks: max abs err {ea:.3e}, max rel "
                f"err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms kernel, {t_p:.4f} ms "
                f"plain [{card}]")
            if name == "float32" and front and nz == 10:
                # dGu, dGv and dGc have the shapes of u, v and c + b
                results["vertical"] = (ea, t_k, t_p, bound(
                    nbytes(*args) + nbytes(u, v, c, b),
                    FLOPS["vertical"] * (u.numel() + c.numel() + b.numel())))

        # layered momentum at Nz = 10 (8 shared planes, no masks)
        u, v = rnd((10, Yb, Xb)), rnd((10, Yb, Xb))
        st = rnd((8, Yb, Xb), lo=1.0)
        st[3] = 0.1 * rnd((Yb, Xb))
        R = momentum.REACH
        I = (slice(R, -R), slice(R, -R))
        errs = [rel_err(gk, wp, I) for gk, wp in zip(
            momentum.momentum(u, v, st, has_mask=False),
            momentum.momentum_plain(u, v, st, has_mask=False))]
        ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
        check(er <= BANDS[name], f"layered momentum {name}: rel err {er:.3e}")
        t_k = time_ms(lambda: momentum.momentum(u, v, st, has_mask=False))
        t_p = time_ms(lambda: momentum.momentum_plain(u, v, st, has_mask=False), n=5)
        log(f"phase 2: momentum_layered {name} on (10, 690, 1450): max abs err {ea:.3e}, "
            f"max rel err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms kernel, "
            f"{t_p:.4f} ms plain [{card}]")
        if name == "float32":
            results["momentum_layered"] = (ea, t_k, t_p, bound(
                nbytes(u, v, st) + 2 * nbytes(u), FLOPS["momentum_layered"] * u.numel()))

        # layered tracer advection, one and two tracer stacks over masked velocities
        mask = masks((10, Yb, Xb))
        u, v = u * mask, v * mask
        iv = rnd((10, Yb, Xb), lo=0.5) * mask
        g2 = rnd((2, Yb, Xb), lo=0.5)
        dz = torch.full((10,), 100.0, dtype=dt, device="cuda")
        R = tracer_adv.REACH
        for n_tr in (1, 2):
            c = rnd((n_tr * 10, Yb, Xb))
            args = (c, u, v, iv, g2, dz)
            ea, er = rel_err(tracer_adv.tracer_adv(*args), tracer_adv.tracer_adv_plain(*args),
                             (slice(R, -R), slice(R, -R)))
            check(er <= BANDS[name], f"layered tracer_adv n_tr={n_tr} {name}: rel err "
                  f"{er:.3e}")
            t_k = time_ms(lambda: tracer_adv.tracer_adv(*args))
            t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(*args), n=5)
            log(f"phase 2: tracer_adv_layered {name} with {n_tr} tracer stack(s) on "
                f"({10 * n_tr}, 690, 1450): max abs err {ea:.3e}, max rel err {er:.3e} "
                f"(band {BANDS[name]:g}); {t_k:.4f} ms kernel, {t_p:.4f} ms plain "
                f"[{card}]")
            if name == "float32" and n_tr == 1:
                results["tracer_adv_layered"] = (ea, t_k, t_p, bound(
                    nbytes(*args) + nbytes(c), FLOPS["tracer_adv_layered"] * c.numel()))
    return results


def phase2_gyre(card):
    """The gyre's kernel modes against their plain versions at (10, 690, 1450):
    momentum with the nu_h and drag planes (one masked layer, 10 layers), tracer
    advection with kappa_h (column, and layered over T and S), the corrector with
    and without b. Returns {name: (max_abs_err at float32, kernel ms, plain ms,
    bound)} for the gyre's own cases."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import (corrector, momentum,
                                                                 tracer_adv)

    results = {}
    Yb, Xb = FILL_SHAPES["base"]
    nz = 10
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(11)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        def masks(shape):
            return torch.as_tensor(rng.random(shape) > 0.15, dtype=dt, device="cuda")

        # momentum with 6 Laplacian and 2 drag planes a layer
        R = momentum.REACH
        I = (slice(R, -R), slice(R, -R))
        for layers in (1, nz):
            shape = (Yb, Xb) if layers == 1 else (layers, Yb, Xb)
            u, v = rnd(shape), rnd(shape)
            st = rnd((10 if layers == 1 else 8, Yb, Xb), lo=1.0)
            st[3] = 0.1 * rnd((Yb, Xb))
            if layers == 1:
                st[8:] = (st[8:] > 1.15).to(dt)
            # each fused term O(1e-1..1) of Gu, so that the float32 band sees it
            lay = rnd((layers, 8, Yb, Xb), lo=0.5)
            lay[:, 6:] *= 0.1
            lay = lay.reshape(8 * layers, Yb, Xb)
            kw = dict(has_mask=layers == 1, lay=lay, has_lap=True, has_drag=True)
            errs = [rel_err(gk, wp, I) for gk, wp in zip(momentum.momentum(u, v, st, **kw),
                                                         momentum.momentum_plain(u, v, st,
                                                                                 **kw))]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            check(er <= BANDS[name], f"momentum closures Nz={layers} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: momentum.momentum(u, v, st, **kw))
            t_p = time_ms(lambda: momentum.momentum_plain(u, v, st, **kw), n=5)
            log(f"phase 2: momentum_closures {name} on {tuple(u.shape)} with nu_h and drag "
                f"planes: max abs err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); "
                f"{t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and layers == nz:
                results["momentum_closures"] = (ea, t_k, t_p, bound(
                    nbytes(u, v, st, lay) + 2 * nbytes(u),
                    FLOPS["momentum_closures"] * u.numel()))

        # tracer advection with kappa_h: column (8-plane pack) and layered (T and S,
        # S = 4 a layer) over masked velocities
        R = tracer_adv.REACH
        I = (slice(R, -R), slice(R, -R))
        c = rnd((Yb, Xb))
        u, v = rnd((Yb, Xb)), rnd((Yb, Xb))
        sa = rnd((8, Yb, Xb), lo=1.0)
        sa[7] *= 0.1  # k_c: the kappa_h term O(1e-1..1) of G
        cases = [("column", (c, u, v, sa))]
        mask = masks((nz, Yb, Xb))
        u3, v3 = rnd((nz, Yb, Xb)) * mask, rnd((nz, Yb, Xb)) * mask
        pack = (mask[:, None] * rnd((nz, 4, Yb, Xb), lo=0.5)).reshape(4 * nz, Yb, Xb)
        dz = torch.full((nz,), 100.0, dtype=dt, device="cuda")
        cases.append(("layered", (rnd((2 * nz, Yb, Xb)), u3, v3, pack,
                                  rnd((2, Yb, Xb), lo=0.5), dz)))
        for mode, args in cases:
            ea, er = rel_err(tracer_adv.tracer_adv(*args), tracer_adv.tracer_adv_plain(*args),
                             I)
            check(er <= BANDS[name], f"tracer_adv kappa {mode} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: tracer_adv.tracer_adv(*args))
            t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(*args), n=5)
            log(f"phase 2: tracer_adv_kappa {mode} {name} on {tuple(args[0].shape)}: max "
                f"abs err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); "
                f"{t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and mode == "layered":
                results["tracer_adv_kappa"] = (ea, t_k, t_p, bound(
                    nbytes(*args) + nbytes(args[0]),
                    FLOPS["tracer_adv_kappa"] * args[0].numel()))

        # the corrector: the gyre's T and S (P = 20, no b) and the front's c and b;
        # U_a and V_a cropped out of the widened free-surface plane
        Ye, Xe = FILL_SHAPES["ext"]
        dy, dx = (Ye - Yb) // 2, (Xe - Xb) // 2
        mu, mv, mc = masks((nz, Yb, Xb)), masks((nz, Yb, Xb)), masks((nz, Yb, Xb))
        dz3 = torch.as_tensor(np.linspace(10.0, 400.0, nz), dtype=dt,
                              device="cuda").view(-1, 1, 1)
        ext = rnd((2, Ye, Xe))
        for n_c, with_b in ((2, False), (1, True)):
            stacks = [rnd((nz, Yb, Xb)) for _ in range(6)]
            tracers = [rnd((n_c * nz, Yb, Xb)) for _ in range(3)]
            b = tuple(rnd((nz, Yb, Xb)) for _ in range(3)) if with_b else None
            args = (*stacks, *tracers, dz3 * mu, dz3 * mv, mc, rnd((Yb, Xb), lo=0.0),
                    rnd((Yb, Xb), lo=0.0), ext[0, dy:dy + Yb, dx:dx + Xb],
                    ext[1, dy:dy + Yb, dx:dx + Xb], *(torch.tensor(x, dtype=dt, device="cuda")
                                                      for x in (1.6, 0.6, 40.0)))
            got = corrector.corrector(*args, b=b)
            want = corrector.corrector_plain(*args, b=b)
            errs = [rel_err(g, w, (slice(None), slice(None)))
                    for g, w in zip(got, want) if w is not None]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            label = "T and S" if n_c == 2 else "c and b"
            check(er <= BANDS[name], f"corrector {label} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: corrector.corrector(*args, b=b))
            t_p = time_ms(lambda: corrector.corrector_plain(*args, b=b), n=5)
            log(f"phase 2: corrector {name} on ({nz}, {Yb}, {Xb}) with {label} (20 tracer "
                f"planes): max abs err {ea:.3e}, max rel err {er:.3e} (band "
                f"{BANDS[name]:g}); {t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and n_c == 2:
                results["corrector"] = (ea, t_k, t_p, bound(
                    nbytes(*args) + nbytes(*got),
                    FLOPS["corrector"] * sum(g.numel() for g in got if g is not None)))
    return results


def phase3_main_path(card, n_steps=20, warm=3):
    """The 1/4-degree Bickley jet through the kernels; returns the launch counts."""
    import torch

    from examples.bickley_jet_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step

    t0 = time.perf_counter()
    model, state = build(1440, 680, dtype=torch.float32, substeps=30, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 3: built the 1440 x 680 model in {time.perf_counter() - t0:.1f} s "
        f"(base {tuple(state.u.shape)}, free surface {tuple(state.eta.shape)}, "
        f"{model.weights.shape[0]} substeps)")
    state = multi_step(model, state, 60.0, warm)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = multi_step(model, state, 60.0, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update(halo_fill=2 * n_steps, halo_fill_copy=6 * n_steps, momentum=n_steps,
                    tracer_adv=n_steps, barotropic=n_steps)
    check(counts == expected, f"launch counts {counts} != {expected}")
    check(tuple(state.u.shape) == (690, 1450) and tuple(state.eta.shape) == (724, 1484),
          "state shapes")
    for name in ("u", "v", "c", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"{name} finite")
    cmin, cmax = float(state.c.min()), float(state.c.max())
    check(-1 - 1e-3 <= cmin and cmax <= 1 + 1e-3, f"c in [-1, 1]: [{cmin}, {cmax}]")
    umax = float(state.u.abs().max())
    log(f"phase 3: {n_steps} steps after {warm} warm-up: {ms:.4f} ms/step "
        f"({1440 * 680 / ms / 1e6:.4f} G grid-points/s), launches {counts}, "
        f"max|u| {umax:.4f}, c in [{cmin:.6f}, {cmax:.6f}] [{card}]")
    return counts, ms


def phase4_parity(card):
    import numpy as np
    import torch

    from examples.bickley_jet_torch import build, diagnostics
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import step

    with np.load(os.path.join(ROOT, "tests", "data", "bickley_oracle_180x90.npz")) as d:
        nx, ny, dt, _, _ = d["meta"]
        ref = {k: d[k] for k in ("u.020", "v.020", "c.020", "eta.020")}
        curves = {k: d[k][:20] for k in ("ke", "ens", "cvar")}
    model, s = build(int(nx), int(ny), dtype=torch.float64, substeps=30, device="cuda")
    kernels.reset_launch_counts()
    got = {"ke": [], "ens": [], "cvar": []}
    for _ in range(20):
        s = step(model, s, float(dt))
        for k, val in zip(("ke", "ens", "cvar"), diagnostics(model, s)):
            got[k].append(val)
    check(kernels.launch_counts()["barotropic"] == 20, "parity run used the kernels")
    g, ge = model.grid, model.grid_ext
    fields = {"u": s.u.cpu().numpy()[g.interior2d], "v": s.v.cpu().numpy()[g.interior2d],
              "c": s.c.cpu().numpy()[g.interior2d],
              "eta": ge.interior(s.eta).cpu().numpy()}
    worst = []
    for name, a in fields.items():
        r = ref[f"{name}.020"]
        diff = float(np.abs(a - r).max())
        worst.append(f"{name} {diff:.3e}")
        check(np.allclose(a, r, rtol=1e-9, atol=1e-12), f"oracle {name}: max diff {diff}")
    for k, ref_curve in curves.items():
        rel = float(np.max(np.abs(np.asarray(got[k]) / ref_curve - 1.0)))
        worst.append(f"{k} rel {rel:.3e}")
        check(np.allclose(got[k], ref_curve, rtol=1e-10, atol=0), f"oracle {k}: rel {rel}")
    log(f"phase 4: 180 x 90 float64 oracle, 20 steps through the kernels: max |diff| "
        f"{', '.join(worst)} (rtol 1e-9, atol 1e-12; curves rtol 1e-10) [{card}]")


def phase5_layered_path(card, n_steps=10, warm=3):
    """The 1/4-degree x 10 baroclinic front through the kernels; returns the launch
    counts."""
    import torch

    from examples.baroclinic_front_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    t0 = time.perf_counter()
    model, state = build(1440, 680, 10, dtype=torch.float32, substeps=30, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 5: built the 1440 x 680 x 10 front in {time.perf_counter() - t0:.1f} s "
        f"(stacks {tuple(state.u.shape)}, free surface {tuple(state.eta.shape)}, "
        f"{model.baro.weights.shape[0]} substeps)")
    dt = 40.0
    state = layered_multi_step(model, state, dt, warm)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = layered_multi_step(model, state, dt, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update(halo_fill_copy=7 * n_steps, halo_fill=2 * n_steps, vertical=n_steps,
                    momentum_layered=n_steps, tracer_adv_layered=2 * n_steps,
                    barotropic=n_steps, corrector=n_steps)
    check(counts == expected, f"layered launch counts {counts} != {expected}")
    check(tuple(state.u.shape) == (10, 690, 1450) and tuple(state.eta.shape) == (724, 1484),
          "layered state shapes")
    for name in ("u", "v", "c", "b", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"front {name} finite")
    umax = float(state.u.abs().max())
    bmin, bmax = float(state.b.min()), float(state.b.max())
    pts = 1440 * 680 * 10
    log(f"phase 5: {n_steps} front steps after {warm} warm-up at dt = {dt:g} s: "
        f"{ms:.4f} ms/step ({pts / ms / 1e6:.4f} G grid-points/s), launches {counts}, "
        f"max|u| {umax:.6f}, b in [{bmin:.6e}, {bmax:.6e}] [{card}]")
    return counts, ms


def phase6_layered_parity(card):
    import numpy as np
    import torch

    from examples.baroclinic_front_torch import build, kinetic_energy
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_step

    with np.load(os.path.join(ROOT, "tests", "data", "front_oracle_120x60x4.npz")) as d:
        nx, ny, nz, dt, _, _ = d["meta"]
        ref = {k: d[k] for k in ("u.015", "v.015", "b.015")}
        ke_ref = d["ke"][:15]
    model, s = build(int(nx), int(ny), int(nz), dtype=torch.float64, device="cuda")
    kernels.reset_launch_counts()
    ke = []
    for _ in range(15):
        s = layered_step(model, s, float(dt))
        ke.append(kinetic_energy(model, s))
    counts = kernels.launch_counts()
    check(all(counts[k] == 15 for k in ("vertical", "momentum_layered", "barotropic")),
          f"layered parity run used the kernels: {counts}")
    I3 = (slice(None),) + model.grid.interior2d
    worst = []
    for name in ("u", "v", "b"):
        a = getattr(s, name).cpu().numpy()[I3]
        r = ref[f"{name}.015"]
        diff = float(np.abs(a - r).max())
        worst.append(f"{name} {diff:.3e}")
        check(np.allclose(a, r, rtol=1e-9, atol=1e-14), f"front oracle {name}: max diff "
              f"{diff}")
    rel = float(np.max(np.abs(np.asarray(ke) / ke_ref - 1.0)))
    worst.append(f"ke rel {rel:.3e}")
    check(np.allclose(ke, ke_ref, rtol=1e-10, atol=0), f"front oracle ke: rel {rel}")
    log(f"phase 6: 120 x 60 x 4 float64 front oracle, 15 steps through the kernels: max "
        f"|diff| {', '.join(worst)} (rtol 1e-9, atol 1e-14; ke rtol 1e-10) [{card}]")


def phase7_gyre_path(card, n_steps=10, warm=3):
    """The 1/4-degree x 10 wind-driven T/S gyre through the kernels; returns the
    launch counts."""
    import torch

    from examples.wind_driven_ts_gyre_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    t0 = time.perf_counter()
    model, state = build(1440, 680, 10, dtype=torch.float32, substeps=30, device="cuda")
    torch.cuda.synchronize()
    log(f"phase 7: built the 1440 x 680 x 10 gyre in {time.perf_counter() - t0:.1f} s "
        f"(stacks {tuple(state.u.shape)}, tracers {tuple(state.c.shape)}, layers "
        f"{', '.join(f'{d:.1f}' for d in model.dz)} m, {model.baro.weights.shape[0]} "
        f"substeps)")
    dt = 40.0
    state = layered_multi_step(model, state, dt, warm)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state = layered_multi_step(model, state, dt, n_steps)
    end.record()
    end.synchronize()
    counts = kernels.launch_counts()
    ms = start.elapsed_time(end) / n_steps
    expected = {k: 0 for k in counts}
    expected.update(halo_fill_copy=6 * n_steps, halo_fill=2 * n_steps, vertical=n_steps,
                    momentum_closures=n_steps, tracer_adv_kappa=n_steps, corrector=n_steps,
                    barotropic=n_steps)
    check(counts == expected, f"gyre launch counts {counts} != {expected}")
    check(tuple(state.u.shape) == (10, 690, 1450) and tuple(state.c.shape) == (20, 690, 1450),
          "gyre state shapes")
    for name in ("u", "v", "c", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"gyre {name} finite")
    I3 = (slice(None),) + model.grid.interior2d
    wet = model.mask_c3[I3] > 0
    T, S = state.c[:10][I3][wet], state.c[10:][I3][wet]
    pts = 1440 * 680 * 10
    log(f"phase 7: {n_steps} gyre steps after {warm} warm-up at dt = {dt:g} s: "
        f"{ms:.4f} ms/step ({pts / ms / 1e6:.4f} G grid-points/s), launches {counts}, "
        f"max|u| {float(state.u.abs().max()):.6f}, T in [{float(T.min()):.4f}, "
        f"{float(T.max()):.4f}], S in [{float(S.min()):.4f}, {float(S.max()):.4f}] "
        f"[{card}]")
    return counts, ms


def phase8_gyre_parity(card, n_steps=3):
    """Three float64 steps of the small check gyre through the kernels against the
    port's plain path on the CPU."""
    import torch

    from examples.wind_driven_ts_gyre_torch import build_check
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    cpu_m, cpu_s = build_check(device="cpu")
    gpu_m, gpu_s = build_check(device="cuda")
    kernels.reset_launch_counts()
    gpu_out = layered_multi_step(gpu_m, gpu_s, 60.0, n_steps)
    counts = kernels.launch_counts()
    check(all(counts[k] == n_steps for k in ("vertical", "momentum_closures",
                                              "tracer_adv_kappa", "corrector")),
          f"gyre parity run used the kernels: {counts}")
    cpu_out = layered_multi_step(cpu_m, cpu_s, 60.0, n_steps)
    I3 = (slice(None),) + cpu_m.grid.interior2d
    worst = []
    for name in ("u", "v", "c", "eta"):
        sl = cpu_m.grid_ext.interior2d if name == "eta" else I3
        w = getattr(cpu_out, name)[sl]
        rel = float((getattr(gpu_out, name).cpu()[sl] - w).abs().max() / w.abs().max())
        worst.append(f"{name} {rel:.3e}")
        check(rel <= 1e-11, f"gyre parity {name}: rel {rel:.3e}")
    log(f"phase 8: 48 x 32 x 3 float64 check gyre, {n_steps} steps through the kernels "
        f"against the CPU plain path: max rel diff {', '.join(worst)} (rtol 1e-11) [{card}]")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = smi_line()
    log(f"phase 0: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from orthogonalsphericalshellgrids_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built in {_build.build_seconds():.1f} s (nvcc), loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    kres = phase2_kernels(card)
    kres.update(phase2_layered(card))
    kres.update(phase2_gyre(card))
    counts, _ = phase3_main_path(card)
    phase4_parity(card)
    front_counts, _ = phase5_layered_path(card)
    phase6_layered_parity(card)
    gyre_counts, _ = phase7_gyre_path(card)
    phase8_gyre_parity(card)

    # each path must have launched every kernel it runs; a row reports the count of
    # the last path that runs it (the gyre's for every kernel of the gyre)
    launches = {}
    for path, names, cnt in (("Bickley", BICKLEY, counts), ("front", FRONT, front_counts),
                             ("gyre", GYRE, gyre_counts)):
        check(all(cnt[n] > 0 for n in names), f"{path} path launched {cnt}")
        launches.update({n: cnt[n] for n in names})
    table = [{"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": REPLACES[name], "launches": launches[name],
              "max_abs_err": kres[name][0], "ms": kres[name][1], "plain_ms": kres[name][2],
              "bound_ms": kres[name][3][0], "bound_by": kres[name][3][1],
              "library_ms": None}
             for name in REPLACES]
    print(json.dumps({"kernels": table}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
