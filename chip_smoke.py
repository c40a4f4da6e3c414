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
Phase 9  the measurement probes (csrc/probes.cu): the barotropic substep probe, the
         WENO-5 probe and the stream and FMA ceiling kernels against their plain
         versions at float32 and float64; then the four ceilings measured through
         them (benchmarks/torch_roofline.py), each kernel's byte bound at the
         measured stream rate (the vertical kernel's linear-EOS mode, the gyre's,
         beside the front's), and the barotropic, momentum and tracer kernels'
         math and WENO bounds beside their phase-2 times.
Phase 10 the phase-7 gyre through utils.Simulation: 100 iterations with the wizard
         and the progress line every 10 and the default NaN checker. It fails if a
         step waits for the card: torch's sync debug mode must count no host
         synchronization at an iteration where no callback fires (and counts one at
         every iteration of a run that reads u after each step). ms/step against
         layered_multi_step, reported against the 3 % target, beside the same run
         with a NaN checker on u, v and c every 10 and the run that reads u after
         each step; the async surface writer and the checkpoint timed on their own;
         a pickup from the checkpoint at iteration 30, resumed to 60 at a fixed
         dt = 40 s, bitwise equal to the uninterrupted run.
Phase 11 the reference's run (BASELINE.md:13): the 180 x 90 float64 Bickley jet,
         50 days through Simulation with the CFL-0.3 wizard (max dt 3 h) and daily
         output; steps, wall time, final invariants, finite fields, the tracer
         range and its conservation.

Phase 2 holds the barotropic kernel, beside the main shape, on five planes from
(26, 28) (smaller than one tile) to (135, 171), none of which the tiles divide, at 7,
17, 21, 31 and 36 substeps (launches shorter than the others), with the wrap on and
off: within the band, finite everywhere, inputs unchanged, and each wrapped halo
column bitwise equal to the column it copies.

Phase 2 also holds the layered kernels against their plain versions: the vertical
column kernel at (10, 690, 1450) in its three modes and at Nz = 50, the layered
momentum kernel at Nz = 10 without and with the front's acc (dGu, dGv) and closing
mask, the layered tracer kernel with 1 and 2 tracers, and the halo fill on a
10-plane stack; and the gyre's modes: momentum with the nu_h and drag planes on one
layer and on 10 (with acc and the closing mask, the gyre's call), tracer advection
with kappa_h in column and layered mode, and the corrector with and without b. Then
the acc/mask_out operands in every mode of the momentum kernel and the acc of the
tracer kernel, at float32 and float64, on the main shape and on three planes the
momentum tiles do not divide, from (7, 9) (smaller than one tile) to (135, 171):
within the band, finite, the edge cells 0, the inputs unchanged. The momentum rows of
the kernel table time the calls the main paths make: one masked layer (Bickley), Nz
= 10 with acc and mask_out (front), and with the closure planes too (gyre); the
layered tracer rows the front's c and the gyre's T and S with acc (dGc).

Prints the kernel table as one JSON line (with each kernel's bound: the larger of
its bytes, every input read once and every output written once, over 3.35 TB/s and
its operations over 67 TFLOP/s at float32, the data sheet's rates; phase 9 prints
the bounds at the measured rates), then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line. Any failed check raises, and the
script exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import (  # noqa: E402
    host_syncs, smi_line, time_ms)

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
    "baro_substep_sol": "benchmarks/roofline.py:121",
    "weno_probe": "benchmarks/weno_sol.py:167",
    # the ceiling kernels stand for the XLA scan bodies of the JAX package's probes
    "stream_probe": "orthogonalsphericalshellgrids_tpu/utils/profiling.py:49",
    "fma_ceiling": "benchmarks/weno_sol.py:215",
}
SOURCE_FILE = {"halo_fill_copy": "halo_fill", "momentum_layered": "momentum",
               "tracer_adv_layered": "tracer_adv", "momentum_closures": "momentum",
               "tracer_adv_kappa": "tracer_adv", "baro_substep_sol": "probes",
               "weno_probe": "probes", "stream_probe": "probes", "fma_ceiling": "probes"}
SOURCES = {name: "orthogonalsphericalshellgrids_tpu_torch/csrc/{}.cu".format(
    SOURCE_FILE.get(name, name)) for name in REPLACES}
# the kernels each main path must launch: the Bickley jet (phase 3), the baroclinic
# front (phase 5) and the gyre (phase 7)
BICKLEY = ("halo_fill", "halo_fill_copy", "barotropic", "momentum", "tracer_adv")
FRONT = ("halo_fill", "halo_fill_copy", "barotropic", "vertical", "momentum_layered",
         "tracer_adv_layered", "corrector")
GYRE = ("halo_fill", "halo_fill_copy", "barotropic", "vertical", "momentum_closures",
        "tracer_adv_kappa", "corrector")
# the kernels the ceilings measurement must launch (phase 9)
PROBES = ("baro_substep_sol", "weno_probe", "stream_probe", "fma_ceiling")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg):
    print(msg, flush=True)


def rel_err(got, want, sl):
    g, w = got[..., sl[0], sl[1]], want[..., sl[0], sl[1]]
    return float((g - w).abs().max()), float((g - w).abs().max() / w.abs().max())


def nbytes(*tensors):
    """Bytes of the tensors (None skipped): each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, flops):
    """(least ms the card could take, what bounds it, the bytes): the larger of the
    bytes over the HBM rate and the operations over the float32 rate. Phase 9 puts
    the same bytes over the measured stream rate."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes", n_bytes) if t_b >= t_f else (t_f, "operations", n_bytes)


# operations per output value, counted from each kernel's arithmetic: the fill's
# sign; per substep and cell the barotropic divergence, gradients and
# updates; momentum's vorticity, two WENO-5 reconstructions and KE gradient (+40
# with the closure planes); tracer advection's four face reconstructions (+12 with
# kappa_h); the vertical pass per layer and tracer block; the corrector's AB2 update
# (+4 with acc and mask_out)
FLOPS = {"halo_fill": 1, "halo_fill_copy": 1, "barotropic": 30, "momentum": 300,
         "momentum_layered": 304, "momentum_closures": 344, "tracer_adv": 300,
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
        kept = [a.clone() for a in (static, eta, U, V, GU, GV)]
        for wrap in (False, True):
            args = (static, eta, U, V, GU, GV, dtau, weights, 1440, 22, wrap)
            for g, w in zip(barotropic.barotropic_substeps(*args),
                            barotropic.barotropic_substeps_plain(*args)):
                ea, er = rel_err(g, w, I)
                check(er <= BANDS[name] and bool(torch.isfinite(g).all()),
                      f"barotropic {name} wrap={wrap}: rel err {er:.3e}")
                errs.append((ea, er))
        check(all(torch.equal(a, b) for a, b in zip(kept, (static, eta, U, V, GU, GV))),
              f"barotropic {name}: inputs unchanged")
        # where the tiles do not fit the plane: a plane smaller than one tile, planes
        # no tile divides, and substep counts that leave a short last launch
        odd = []
        for substeps, Ny, Nx in ((10, 10, 12), (24, 53, 37), (30, 53, 37), (44, 61, 97),
                                 (50, 61, 97)):
            w_np = averaging_weights(substeps)[1]
            n, H = len(w_np), len(w_np) + 1
            sp = rnd((9, Ny + 2 * H, Nx + 2 * H), lo=0.5)
            sp[7:] = (sp[7:] > 0.6).to(dt)
            dyn = [rnd(sp.shape[1:], 0.01) for _ in range(3)] + [
                rnd(sp.shape[1:], 1e-3) for _ in range(2)]
            planes = [sp, *dyn]
            kept = [a.clone() for a in planes]
            for wrap in (False, True):
                args = (*planes, dtau, torch.as_tensor(w_np, dtype=dt, device="cuda"), Nx,
                        H, wrap)
                Iv = (slice(n, -n), slice(None) if wrap else slice(n, -n))
                for g, w in zip(barotropic.barotropic_substeps(*args),
                                barotropic.barotropic_substeps_plain(*args)):
                    er = rel_err(g, w, Iv)[1]
                    halo = not wrap or (torch.equal(g[:, :H], g[:, Nx:Nx + H]) and
                                        torch.equal(g[:, H + Nx:], g[:, H:2 * H]))
                    check(er <= BANDS[name] and bool(torch.isfinite(g).all()) and halo,
                          f"barotropic {name} {tuple(sp.shape[1:])} {n} substeps "
                          f"wrap={wrap}: rel err {er:.3e}, halo columns bitwise {halo}")
                    odd.append(er)
            check(all(torch.equal(a, b) for a, b in zip(kept, planes)),
                  f"barotropic {name} {tuple(sp.shape[1:])}: inputs unchanged")
        log(f"phase 2: barotropic {name} on five planes from (26, 28) to (135, 171) with "
            f"7, 17, 21, 31 and 36 substeps, wrap on and off: max rel err {max(odd):.3e} "
            f"(band {BANDS[name]:g}), finite, inputs unchanged, wrapped halo columns "
            f"bitwise [{card}]")
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
            if name == "float32" and nz == 10 and mode != "none":
                # dGu, dGv and dGc have the shapes of u, v and c (+ b); the front's
                # mode is the table's row, the gyre's (linear EOS) has its bound in
                # phase 9
                key = "vertical" if front else "vertical_linear_eos"
                n_out = c.numel() + (b.numel() if b is not None else 0)
                results[key] = (ea, t_k, t_p, bound(
                    nbytes(*args) + nbytes(u, v, c, b),
                    FLOPS["vertical"] * (u.numel() + n_out)))

        # layered momentum at Nz = 10 (8 shared planes, no masks), without operands
        # and with the front's: acc (dGu, dGv, O(1e-1..1) of G) and the closing mask
        u, v = rnd((10, Yb, Xb)), rnd((10, Yb, Xb))
        st = rnd((8, Yb, Xb), lo=1.0)
        st[3] = 0.1 * rnd((Yb, Xb))
        R = momentum.REACH
        I = (slice(R, -R), slice(R, -R))
        fold = dict(acc=(rnd((10, Yb, Xb), 0.5), rnd((10, Yb, Xb), 0.5)),
                    mask_out=(masks((10, Yb, Xb)), masks((10, Yb, Xb))))
        for label, kw in (("without operands", {}), ("with acc and mask_out", fold)):
            errs = [rel_err(gk, wp, I) for gk, wp in zip(
                momentum.momentum(u, v, st, has_mask=False, **kw),
                momentum.momentum_plain(u, v, st, has_mask=False, **kw))]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            check(er <= BANDS[name], f"layered momentum {label} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: momentum.momentum(u, v, st, has_mask=False, **kw))
            t_p = time_ms(lambda: momentum.momentum_plain(u, v, st, has_mask=False, **kw),
                          n=5)
            log(f"phase 2: momentum_layered {name} on (10, 690, 1450) {label}: max abs "
                f"err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms "
                f"kernel, {t_p:.4f} ms plain [{card}]")
        if name == "float32":  # the front's call: the operands' 4 stacks count
            results["momentum_layered"] = (ea, t_k, t_p, bound(
                nbytes(u, v, st, *fold["acc"], *fold["mask_out"]) + 2 * nbytes(u),
                FLOPS["momentum_layered"] * u.numel()))

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
            # the front's call adds dGc in the kernel (acc, O(1e-1..1) of G)
            kw = dict(acc=rnd(c.shape, 0.5)) if n_tr == 1 else {}
            ea, er = rel_err(tracer_adv.tracer_adv(*args, **kw),
                             tracer_adv.tracer_adv_plain(*args, **kw),
                             (slice(R, -R), slice(R, -R)))
            check(er <= BANDS[name], f"layered tracer_adv n_tr={n_tr} {name}: rel err "
                  f"{er:.3e}")
            t_k = time_ms(lambda: tracer_adv.tracer_adv(*args, **kw))
            t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(*args, **kw), n=5)
            log(f"phase 2: tracer_adv_layered {name} with {n_tr} tracer stack(s) on "
                f"({10 * n_tr}, 690, 1450){' with acc' if kw else ''}: max abs err "
                f"{ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms "
                f"kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and n_tr == 1:
                results["tracer_adv_layered"] = (ea, t_k, t_p, bound(
                    nbytes(*args, kw["acc"]) + nbytes(c),
                    FLOPS["tracer_adv_layered"] * c.numel()))
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
            if layers == nz:  # the gyre's call: acc and the closing mask as well
                kw.update(acc=(rnd(shape, 0.5), rnd(shape, 0.5)),
                          mask_out=(masks(shape), masks(shape)))
            errs = [rel_err(gk, wp, I) for gk, wp in zip(momentum.momentum(u, v, st, **kw),
                                                         momentum.momentum_plain(u, v, st,
                                                                                 **kw))]
            ea, er = max(e[0] for e in errs), max(e[1] for e in errs)
            check(er <= BANDS[name], f"momentum closures Nz={layers} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: momentum.momentum(u, v, st, **kw))
            t_p = time_ms(lambda: momentum.momentum_plain(u, v, st, **kw), n=5)
            log(f"phase 2: momentum_closures {name} on {tuple(u.shape)} with nu_h and drag "
                f"planes{' and acc and mask_out' if 'acc' in kw else ''}: max abs err "
                f"{ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g}); {t_k:.4f} ms "
                f"kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and layers == nz:
                results["momentum_closures"] = (ea, t_k, t_p, bound(
                    nbytes(u, v, st, lay, *kw["acc"], *kw["mask_out"]) + 2 * nbytes(u),
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
            # the gyre's layered call adds dGc in the kernel (acc)
            kw = dict(acc=rnd(args[0].shape, 0.5)) if mode == "layered" else {}
            ea, er = rel_err(tracer_adv.tracer_adv(*args, **kw),
                             tracer_adv.tracer_adv_plain(*args, **kw), I)
            check(er <= BANDS[name], f"tracer_adv kappa {mode} {name}: rel err {er:.3e}")
            t_k = time_ms(lambda: tracer_adv.tracer_adv(*args, **kw))
            t_p = time_ms(lambda: tracer_adv.tracer_adv_plain(*args, **kw), n=5)
            log(f"phase 2: tracer_adv_kappa {mode} {name} on {tuple(args[0].shape)}"
                f"{' with acc' if kw else ''}: max abs err {ea:.3e}, max rel err {er:.3e} "
                f"(band {BANDS[name]:g}); {t_k:.4f} ms kernel, {t_p:.4f} ms plain [{card}]")
            if name == "float32" and mode == "layered":
                results["tracer_adv_kappa"] = (ea, t_k, t_p, bound(
                    nbytes(*args, kw["acc"]) + nbytes(args[0]),
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


def phase2_operands(card):
    """acc/mask_out in every mode of the momentum kernel and acc in every mode of the
    tracer kernel, at float32 and float64, on the main shape and on three planes the
    momentum tiles do not divide: within the band, finite, the edge cells 0, the
    inputs unchanged."""
    import numpy as np
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.kernels import momentum, tracer_adv

    R = momentum.REACH
    shapes = [FILL_SHAPES["base"], (7, 9), (37, 131), (135, 171)]
    # (layers, has_lap, has_drag, acc, mask_out); 1 is one masked layer
    modes = [(1, False, False, True, True), (1, True, True, True, False),
             (10, False, False, True, True), (10, False, False, False, True),
             (10, True, True, True, True), (10, False, True, True, False),
             (10, True, False, True, True)]
    worst = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        rng = np.random.default_rng(19)

        def rnd(shape, scale=1.0, lo=None):
            a = rng.random(shape) + lo if lo is not None else scale * rng.standard_normal(shape)
            return torch.as_tensor(a, dtype=dt, device="cuda")

        def masks(shape):
            return torch.as_tensor(rng.random(shape) > 0.15, dtype=dt, device="cuda")

        errs = []
        for Yb, Xb in shapes:
            I = (slice(R, -R), slice(R, -R))
            for layers, lap, drag, acc, out in modes:
                shape = (Yb, Xb) if layers == 1 else (layers, Yb, Xb)
                u, v = rnd(shape), rnd(shape)
                st = rnd((10 if layers == 1 else 8, Yb, Xb), lo=1.0)
                st[3] = 0.1 * rnd((Yb, Xb))
                if layers == 1:
                    st[8:] = (st[8:] > 1.15).to(dt)
                L = 6 * lap + 2 * drag
                kw = dict(has_mask=layers == 1, has_lap=lap, has_drag=drag, lay=None)
                if L:
                    lay = rnd((layers, L, Yb, Xb), lo=0.5)
                    lay[:, 6 * lap:] *= 0.1
                    kw["lay"] = lay.reshape(layers * L, Yb, Xb)
                if acc:
                    kw["acc"] = (rnd(shape, 0.5), rnd(shape, 0.5))
                if out:
                    kw["mask_out"] = (masks(shape), masks(shape))
                kept = [a.clone() for a in (u, v, st)]
                got = momentum.momentum(u, v, st, **kw)
                want = momentum.momentum_plain(u, v, st, **kw)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    edge = all(bool((strip == 0).all()) for strip in (
                        g[..., :R, :], g[..., -R:, :], g[..., :R], g[..., -R:]))
                    er = rel_err(g, w, I)[1] if min(Yb, Xb) > 2 * R + 1 else 0.0
                    check(er <= BANDS[name] and bool(torch.isfinite(g).all()) and edge and
                          all(torch.equal(a, b) for a, b in zip(kept, (u, v, st))),
                          f"momentum {name} {shape} lap={lap} drag={drag} acc={acc} "
                          f"mask_out={out}: rel err {er:.3e}, edge zeros {edge}")
                    errs.append(er)
        Yb, Xb = FILL_SHAPES["base"]
        I = (slice(R, -R), slice(R, -R))
        mask = masks((10, Yb, Xb))
        u3, v3 = rnd((10, Yb, Xb)) * mask, rnd((10, Yb, Xb)) * mask
        g2, dz = rnd((2, Yb, Xb), lo=0.5), torch.full((10,), 100.0, dtype=dt, device="cuda")
        cases = [(rnd((Yb, Xb)), rnd((Yb, Xb)), rnd((Yb, Xb)), rnd((S, Yb, Xb), lo=1.0))
                 for S in (5, 8)]
        cases += [(rnd((n_tr * 10, Yb, Xb)), u3, v3,
                   (mask[:, None] * rnd((10, S, Yb, Xb), lo=0.5)).reshape(S * 10, Yb, Xb),
                   g2, dz) for n_tr, S in ((1, 1), (2, 1), (2, 4))]
        for args in cases:
            a = rnd(args[0].shape, 0.5)
            g = tracer_adv.tracer_adv(*args, acc=a)
            er = rel_err(g, tracer_adv.tracer_adv_plain(*args, acc=a), I)[1]
            check(er <= BANDS[name] and bool(torch.isfinite(g).all()),
                  f"tracer_adv acc {name} {tuple(args[0].shape)} pack "
                  f"{tuple(args[3].shape)}: rel err {er:.3e}")
            errs.append(er)
        worst[name] = max(errs)
        log(f"phase 2: operands {name}: momentum with acc/mask_out in 7 modes on "
            f"{', '.join(str(sh) for sh in shapes)} and tracer_adv with acc in column "
            f"(5 and 8 planes) and layered mode (1 and 2 tracers, S = 1 and 4): max rel "
            f"err {worst[name]:.3e} (band {BANDS[name]:g}), finite, edge cells 0, inputs "
            f"unchanged [{card}]")
    return worst


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
    launch counts, ms/step, and the model with its initial state for phase 10."""
    import torch

    from examples.wind_driven_ts_gyre_torch import build
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step

    t0 = time.perf_counter()
    model, state = build(1440, 680, 10, dtype=torch.float32, substeps=30, device="cuda")
    state0 = state
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
    return counts, ms, model, state0


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


def phase9_probes(card, kres):
    """The two probes and the two ceiling kernels against their plain versions at the
    measurement's shapes (f32 and f64), then the four ceilings measured through them
    and the bounds they put on the kernels of phase 2. Returns ({name: (max_abs_err at
    f32, kernel ms, plain ms, bound, library ms)}, the measurement's launch counts)."""
    import torch

    from benchmarks import torch_roofline as roof
    from benchmarks.torch_weno_sol import (FLOPS_PER_RECONSTRUCTION, WENO_ITER,
                                           probe_input)
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes

    whole = (slice(None), slice(None))
    n_tiles = roof.baro_n_tiles()
    rows = {}
    for name in ("float32", "float64"):
        dt = getattr(torch, name)
        f32 = name == "float32"

        # the barotropic substep probe: every tile, all three accumulators, at the
        # measurement's length (the iterate is smooth, so the full length compares)
        spack, dpack, dtau = roof.baro_inputs(n_tiles, dtype=dt)
        got = probes.baro_substep_sol(spack, dpack, dtau, roof.BARO_ITER)
        want = probes.baro_substep_sol_plain(spack, dpack, dtau, roof.BARO_ITER)
        ea, er = rel_err(got, want, whole)
        check(er <= BANDS[name] and bool(torch.isfinite(got).all()),
              f"baro_substep_sol {name}: rel err {er:.3e}")
        t_p = time_ms(lambda: probes.baro_substep_sol_plain(spack, dpack, dtau,
                                                            roof.BARO_ITER), n=1, reps=1,
                      warm=0) if f32 else float("nan")
        log(f"phase 9: baro_substep_sol {name} on {tuple(spack.shape)}, {roof.BARO_ITER} "
            f"substeps: max abs err {ea:.3e}, max rel err {er:.3e} (band {BANDS[name]:g})"
            f"{f'; plain {t_p:.4f} ms' if f32 else ''} [{card}]")
        if f32:
            rows["baro_substep_sol"] = (ea, None, t_p, bound(
                nbytes(spack, dpack, dtau, got),
                probes.BARO_FLOPS * got[:, 0].numel() * roof.BARO_ITER), None)

        # the WENO-5 probe: the upwind select flips on a rounding difference near 0
        # and the flip spreads, so it compares at 1 and 4 iterations, and a point
        # outside the band may be at most 1e-4 of the points
        x = probe_input(dtype=dt)
        worst = []
        for n_iter in (1, 4):
            for upwind in (True, False):
                got = probes.weno_probe(x, n_iter, upwind)
                want = probes.weno_probe_plain(x, n_iter, upwind)
                diff = (got - want).abs()
                out_of_band = float((diff > BANDS[name] * want.abs().max()).double().mean())
                check(out_of_band < 1e-4 and bool(torch.isfinite(got).all()),
                      f"weno_probe {name} n_iter={n_iter} upwind={upwind}: {out_of_band:.2e} "
                      f"of the points outside the band")
                worst.append((float(diff.max()), float(diff.max() / want.abs().max()),
                              out_of_band))
        ea = max(w[0] for w in worst)
        t_p = time_ms(lambda: probes.weno_probe_plain(x, WENO_ITER), n=1, reps=1,
                      warm=0) if f32 else float("nan")
        log(f"phase 9: weno_probe {name} on {tuple(x.shape)}, 1 and 4 iterations, upwind "
            f"and left-biased: max abs err {ea:.3e}, max rel err "
            f"{max(w[1] for w in worst):.3e}, outside the band {max(w[2] for w in worst):.2e}"
            f" of the points (band {BANDS[name]:g})"
            f"{f'; plain at {WENO_ITER} iterations {t_p:.4f} ms' if f32 else ''} [{card}]")
        if f32:
            rows["weno_probe"] = (ea, None, t_p, bound(
                2 * nbytes(x), FLOPS_PER_RECONSTRUCTION * x.numel() * WENO_ITER), None)

        # the stream kernel, and the one PyTorch call that computes the same function
        xs = torch.arange(roof.STREAM_N, dtype=dt, device="cuda")
        ys = torch.empty_like(xs)
        want = probes.stream_probe_plain(xs)
        ea, er = rel_err(probes.stream_probe(xs, out=ys).view(1, -1), want.view(1, -1),
                         whole)
        check(er <= BANDS[name], f"stream_probe {name}: rel err {er:.3e}")
        half = torch.tensor(0.5, dtype=dt, device="cuda")
        lib = torch.add(half, xs, alpha=1.000001)
        check(rel_err(lib.view(1, -1), want.view(1, -1), whole)[1] <= BANDS[name],
              f"torch.add {name} as the stream")
        if f32:
            t_p = time_ms(lambda: probes.stream_probe_plain(xs), n=5)
            t_lib = time_ms(lambda: torch.add(half, xs, alpha=1.000001, out=ys), n=5)
            t_copy = time_ms(lambda: ys.copy_(xs), n=5)
            rows["stream_probe"] = (ea, None, t_p, bound(2 * nbytes(xs), 2 * xs.numel()),
                                    t_lib)
            log(f"phase 9: stream_probe {name} on {xs.numel()} elements: max abs err "
                f"{ea:.3e}, max rel err {er:.3e}; plain {t_p:.4f} ms, torch.add {t_lib:.4f}"
                f" ms, copy_ of the same bytes {t_copy:.4f} ms [{card}]")
        del xs, ys, lib, want

        # the FMA ceiling kernel
        xf = torch.full((roof.FMA_N,), 0.999, dtype=dt, device="cuda")
        ea, er = rel_err(probes.fma_ceiling(xf, roof.FMA_ITER).view(1, -1),
                         probes.fma_ceiling_plain(xf, roof.FMA_ITER).view(1, -1), whole)
        check(er <= BANDS[name], f"fma_ceiling {name}: rel err {er:.3e}")
        t_p = time_ms(lambda: probes.fma_ceiling_plain(xf, roof.FMA_ITER), n=1, reps=1,
                      warm=0) if f32 else float("nan")
        log(f"phase 9: fma_ceiling {name} on {xf.numel()} elements x {roof.FMA_ITER}: max "
            f"abs err {ea:.3e}, max rel err {er:.3e}{f'; plain {t_p:.4f} ms' if f32 else ''}"
            f" [{card}]")
        if f32:
            rows["fma_ceiling"] = (ea, None, t_p, bound(
                2 * nbytes(xf), probes.FMA_FLOPS * xf.numel() * roof.FMA_ITER), None)

    # the ceilings: the path that runs these four kernels
    kernels.reset_launch_counts()
    ceil = roof.measure()
    counts = kernels.launch_counts()
    check(all(counts[n] > 0 for n in PROBES) and
          all(c == 0 for n, c in counts.items() if n not in PROBES),
          f"the ceilings launched {counts}")
    # a reading above the data sheet means the timing window is broken
    check(ceil["stream_gbps"] <= 1.02 * HBM_BYTES_PER_S / 1e9,
          f"stream {ceil['stream_gbps']:.1f} GB/s above the data sheet")
    check(ceil["fma_tflops"] <= 1.02 * F32_FLOPS_PER_S / 1e12,
          f"FMA {ceil['fma_tflops']:.2f} TFLOP/s above the data sheet")
    for name, key in (("baro_substep_sol", "baro_ms"), ("weno_probe", "weno_ms"),
                      ("stream_probe", "stream_ms"), ("fma_ceiling", "fma_ms")):
        ea, _, t_p, b, t_lib = rows[name]
        rows[name] = (ea, ceil[key], t_p, b, t_lib)
        log(f"phase 9: {name} kernel {ceil[key]:.4f} ms, plain {t_p:.4f} ms, data-sheet "
            f"bound {b[0]:.5f} ms ({b[1]}) [{card}]")
    # each kernel's byte bound at the measured stream rate: the bytes of its phase-2
    # operands, the same count as its data-sheet bound
    roof.report(ceil, card, log=lambda m: log(f"phase 9: {m}"),
                kernel_ms={name: row[1] for name, row in kres.items()},
                kernel_bytes={name: row[3][2] for name, row in kres.items()})
    log(f"phase 9: launches {counts}")
    return rows, counts


def phase10_simulation(card, model, state0, n_iter=60, n_time=100, warm=3):
    """The 1/4-degree x 10 gyre through ``Simulation``: no host synchronization at an
    iteration where no callback fires (torch's sync debug mode); its cost over
    ``layered_multi_step`` over ``n_time`` iterations with the wizard and the progress
    line every 10 and the default NaN checker (u every 100 iterations), beside a run
    that reads u after every step; the async surface writer and the checkpoint timed
    on their own; and a pickup from the checkpoint at iteration 30, resumed to
    ``n_iter``, bitwise against the uninterrupted run at a fixed dt = 40 s (a
    checkpoint holds the state, not the wizard's dt). Returns the launch counts of
    one Simulation run."""
    import dataclasses
    import tempfile

    import torch

    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step
    from orthogonalsphericalshellgrids_tpu_torch.utils import (
        Checkpointer, FieldTimeSeries, IterationInterval, NaNChecker, OutputWriter,
        Simulation, TimeStepWizard, progress_callback)

    nz, dt = model.nz, 40.0
    progress = []
    warm_state = layered_multi_step(model, state0, dt, warm)
    torch.cuda.synchronize()

    def multi():
        return layered_multi_step(model, warm_state, dt, n_time)

    def driven(kind="sim", probe=None):
        """The wizard and the progress line every 10 iterations and the default NaN
        checker (``sim``); with a NaN checker on u, v and c every 10 iterations in
        place of the default one (``strict``); or ``sim`` plus a host read of one
        value of u after every step (``synced``), the wait the loop must not make.
        ``probe`` runs after every step, after the other callbacks."""
        sim = Simulation(model, warm_state, dt=dt, stop_iteration=warm + n_time,
                         nan_checker=kind != "strict")
        wizard = TimeStepWizard(cfl=0.25, max_change=1.1, max_dt=3600.0)
        sim.add_callback(lambda s: setattr(s, "dt", wizard.update(s.model, s.state, s.dt)),
                         IterationInterval(10))
        sim.add_callback(progress_callback(progress.append), IterationInterval(10))
        if kind == "strict":
            sim.add_callback(NaNChecker(("u", "v", "c")), IterationInterval(10))
        if kind == "synced":
            sim.add_callback(lambda s: float(s.state.u[0, 0, 0]), IterationInterval(1))
        if probe is not None:
            sim.add_callback(probe, IterationInterval(1))
        return sim.run()

    def syncs_per_iteration(kind):
        """{iteration: host synchronizations in its step and its callbacks}: torch's
        sync debug mode counts them, read by a probe after every step (the first
        iteration, which also holds the Simulation's construction, is left out)."""
        marks = []
        with host_syncs() as n_syncs:
            driven(kind, probe=lambda s: marks.append((s.iteration, n_syncs())))
        return {it: n - prev for (_, prev), (it, n) in zip(marks, marks[1:])}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_time * 1e3

    driven("strict")  # the first launches of the callbacks' reductions load them
    syncs = {kind: syncs_per_iteration(kind) for kind in ("sim", "synced")}
    quiet = [it for it in syncs["sim"] if it % 10]  # no callback but the probe fires
    loud = sorted(set(syncs["sim"]) - set(quiet))
    check(len(quiet) >= n_time * 8 // 10 and all(syncs["synced"][it] >= 1 for it in quiet),
          f"the sync count sees a host read after every step: {syncs['synced']}")
    check(all(syncs["sim"][it] == 0 for it in quiet),
          f"Simulation waited for the card at an iteration without a callback: "
          f"{ {it: n for it, n in syncs['sim'].items() if n and it in quiet} }")
    times = {"multi": [], "sim": [], "strict": [], "synced": []}
    runs = {"multi": multi, "sim": driven, "strict": lambda: driven("strict"),
            "synced": lambda: driven("synced")}
    for which in ("multi", "sim", "strict", "synced", "synced", "strict", "sim", "multi",
                  "multi", "sim", "strict", "synced"):
        if which == "sim" and not times["sim"]:
            kernels.reset_launch_counts()
            times["sim"].append(wall_ms(driven))
            counts = kernels.launch_counts()
        else:
            times[which].append(wall_ms(runs[which]))
    expected = {k: 0 for k in counts}
    expected.update(halo_fill_copy=6 * n_time, halo_fill=2 * n_time, vertical=n_time,
                    momentum_closures=n_time, tracer_adv_kappa=n_time, corrector=n_time,
                    barotropic=n_time)
    check(counts == expected, f"Simulation launch counts {counts} != {expected}")
    best = {k: min(v) for k, v in times.items()}
    over = {k: best[k] / best["multi"] - 1.0 for k in ("sim", "strict", "synced")}
    log(f"phase 10: {n_time} gyre iterations: host synchronizations 0 at each of the "
        f"{len(quiet)} iterations without a callback, "
        f"{sum(syncs['sim'][it] for it in loud)} at the {len(loud)} with one; "
        f"{sum(syncs['synced'].values())} with a host read after every step [{card}]")
    log(f"phase 10: ms/step through Simulation (wizard and progress every 10, the "
        f"default NaN checker) {', '.join(f'{t:.4f}' for t in times['sim'])}; with a NaN "
        f"checker on u, v and c every 10 {', '.join(f'{t:.4f}' for t in times['strict'])}"
        f"; with a host read after every step "
        f"{', '.join(f'{t:.4f}' for t in times['synced'])}; layered_multi_step "
        f"{', '.join(f'{t:.4f}' for t in times['multi'])}; Simulation costs "
        f"{100 * over['sim']:+.2f} % ({100 * over['strict']:+.2f} % with the NaN checker "
        f"every 10, {100 * over['synced']:+.2f} % with a read after every step; best "
        f"against best; the target of at most 3 % "
        f"{'held' if over['sim'] <= 0.03 else 'missed'}); last progress line: "
        f"{progress[-1]} [{card}]")

    class Timed:
        """A callback that times ``fn`` on the host, the card drained first."""

        def __init__(self, fn):
            self.fn, self.ms = fn, []

        def __call__(self, sim):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.fn(sim)
            self.ms.append((time.perf_counter() - t0) * 1e3)

    surface = {"T_surface": lambda s: s.state.c[0], "S_surface": lambda s: s.state.c[nz],
               "u_surface": lambda s: s.state.u[0]}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(os.path.join(tmp, "gyre"))
        paths = {k: os.path.join(tmp, f"surface_{k}.npz") for k in ("once", "resumed")}
        ends, drain_ms, write_ms = {}, {}, []
        for run in ("once", "resumed"):
            writer = OutputWriter(paths[run], surface, async_write=True)
            sim = Simulation(model, state0, dt=dt, stop_iteration=n_iter)
            sim.add_callback(progress_callback(progress.append), IterationInterval(10))
            timed_writer = Timed(writer)
            timed_writer.ms = write_ms
            sim.add_callback(timed_writer, IterationInterval(20))
            if run == "once":
                timed_ckpt = Timed(ckpt)
                sim.add_callback(timed_ckpt, IterationInterval(30))
            ends[run] = sim.run(pickup=ckpt.path_for(30) if run == "resumed" else None)
            t0 = time.perf_counter()
            writer.close()  # the Timed wrapper hides close() from the Simulation
            drain_ms[run] = (time.perf_counter() - t0) * 1e3
            check(sim.iteration == n_iter, f"{run} run ended at iteration {sim.iteration}")
        ckpt_mb = os.path.getsize(ckpt.path_for(30)) / 2**20
        for f in dataclasses.fields(ends["once"]):
            check(torch.equal(getattr(ends["resumed"], f.name), getattr(ends["once"], f.name)),
                  f"pickup at iteration 30: {f.name} not bitwise equal to the uninterrupted "
                  f"run")
        once = {k: FieldTimeSeries(paths["once"], k) for k in surface}
        resumed = {k: FieldTimeSeries(paths["resumed"], k) for k in surface}
        for k in surface:
            check(len(once[k]) == 3 and len(resumed[k]) == 2, f"{k} snapshots")
            check((resumed[k].data == once[k].data[1:]).all() and
                  (resumed[k].times == once[k].times[1:]).all(),
                  f"{k}: the resumed run's snapshots differ from the uninterrupted run's")
            check(bool((abs(once[k].data) < float("inf")).all()), f"{k} finite")
    log(f"phase 10: pickup at iteration 30 resumed to {n_iter} bitwise equal to the "
        f"uninterrupted run (every field, and the snapshots at 40 and 60) at dt = {dt:g} "
        f"s; async surface writer (T, S, u) {', '.join(f'{t:.2f}' for t in write_ms)}"
        f" ms a snapshot on the simulation thread, drain {drain_ms['resumed']:.2f} ms; "
        f"checkpoint {', '.join(f'{t:.1f}' for t in timed_ckpt.ms)} ms for {ckpt_mb:.1f} MB "
        f"[{card}]")
    return counts


def phase11_bickley_50_days(card, days=50.0):
    """The reference's run (BASELINE.md:13): the 180 x 90 Bickley jet through
    ``Simulation`` at float64, CFL-0.3 wizard with max dt 3 h from dt = 60 s, daily
    output of u, v, c and zeta; steps, wall time, final invariants, finite fields and
    phase 3's tracer range."""
    import tempfile

    import numpy as np
    import torch

    from examples.bickley_jet_torch import build, diagnostics, make_simulation
    from orthogonalsphericalshellgrids_tpu_torch import kernels
    from orthogonalsphericalshellgrids_tpu_torch.models.diagnostics import (
        surface_volume, tracer_content)
    from orthogonalsphericalshellgrids_tpu_torch.utils import FieldTimeSeries

    model, state = build(180, 90, dtype=torch.float64, substeps=30, device="cuda")
    c0 = float(tracer_content(model, state))
    progress = []
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bickley.npz")
        sim = make_simulation(model, state, days=days, dt=60.0, out=out,
                              log=progress.append)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = sim.run()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        zeta = FieldTimeSeries(out, "zeta")
        check(len(zeta) >= int(days) and bool(np.isfinite(zeta.data).all()),
              f"{len(zeta)} daily zeta snapshots, finite")
    check(abs(sim.time - days * 86400.0) < 1e-6, f"stopped at t = {sim.time}")
    check(all(counts[n] > 0 for n in BICKLEY) and counts["barotropic"] == sim.iteration,
          f"the 50-day run launched {counts} in {sim.iteration} iterations")
    for name in ("u", "v", "c", "eta", "U", "V"):
        check(bool(torch.isfinite(getattr(s, name)).all()), f"50-day {name} finite")
    cmin, cmax = float(s.c.min()), float(s.c.max())
    check(-1 - 1e-3 <= cmin and cmax <= 1 + 1e-3, f"c in [-1, 1]: [{cmin}, {cmax}]")
    ke, ens, cvar = diagnostics(model, s)
    c1 = float(tracer_content(model, s))
    # flux-form advection with the seam row half-weighted conserves it to round-off
    check(abs(c1 / c0 - 1.0) <= 1e-9, f"tracer content {c0} -> {c1}")
    log(f"phase 11: the 180 x 90 float64 Bickley jet, {days:g} days through Simulation: "
        f"{sim.iteration} steps in {wall:.1f} s ({wall / sim.iteration * 1e3:.3f} ms a "
        f"step with the callbacks), last dt {sim.dt:.1f} s, {len(zeta)} daily snapshots; "
        f"final ke {ke:.6e}, enstrophy {ens:.6e}, tracer variance {cvar:.6e}, tracer "
        f"content {c1:.12e} (relative change {c1 / c0 - 1:.2e}), surface volume "
        f"{float(surface_volume(model, s)):.6e}, c in [{cmin:.6f}, {cmax:.6f}], max|u| "
        f"{float(s.u.abs().max()):.4f}; {progress[-1]} [{card}]")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
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
    phase2_operands(card)
    counts, _ = phase3_main_path(card)
    phase4_parity(card)
    front_counts, _ = phase5_layered_path(card)
    phase6_layered_parity(card)
    gyre_counts, _, gyre_model, gyre_state0 = phase7_gyre_path(card)
    phase8_gyre_parity(card)
    probe_rows, probe_counts = phase9_probes(card, kres)
    kres.update(probe_rows)
    phase10_simulation(card, gyre_model, gyre_state0)
    del gyre_model, gyre_state0
    phase11_bickley_50_days(card)

    # each path must have launched every kernel it runs; a row reports the count of
    # the last path that runs it (the gyre's for every kernel of the gyre)
    launches = {}
    for path, names, cnt in (("Bickley", BICKLEY, counts), ("front", FRONT, front_counts),
                             ("gyre", GYRE, gyre_counts), ("ceilings", PROBES, probe_counts)):
        check(all(cnt[n] > 0 for n in names), f"{path} path launched {cnt}")
        launches.update({n: cnt[n] for n in names})
    table = [{"name": name, "route": "cuda", "source": SOURCES[name],
              "replaces": REPLACES[name], "launches": launches[name],
              "max_abs_err": kres[name][0], "ms": kres[name][1], "plain_ms": kres[name][2],
              "bound_ms": kres[name][3][0], "bound_by": kres[name][3][1],
              "library_ms": kres[name][4] if len(kres[name]) > 4 else None}
             for name in REPLACES]
    print(json.dumps({"kernels": table}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
