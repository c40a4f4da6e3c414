#!/usr/bin/env python3
"""Measured ceilings of one CUDA card, and the bounds they put on the port's kernels.

    python3 benchmarks/torch_roofline.py

Counterpart of the ceilings half of ``benchmarks/roofline.py`` (its components half,
the step, tendencies and fill, is ``benchmarks/torch_profile_*.py``). It measures,
each as one hand-written kernel timed with CUDA events (``kernels/probes.py``):

- the HBM stream rate (GB/s; ``utils/profiling.py:stream_probe_gbps``);
- the float32 FMA rate (TFLOP/s; ``utils/profiling.py:fma_ceiling``);
- the WENO-5 rate (G reconstructions/s; ``benchmarks/torch_weno_sol.py``);
- the barotropic substep rate with the state on chip (G point-substeps/s;
  ``probes.baro_substep_sol`` over a batch of periodic tiles, every SM busy).

From those it derives, for the shapes of the 1/4-degree main paths (float32):

- the barotropic kernel's math bound: 21 substeps x 724 x 1484 point-substeps over
  the probe's rate;
- the momentum and tracer kernels' WENO bounds: their reconstructions per call
  (``MAIN_PATH``, counted from ``csrc/momentum.cu`` and ``csrc/tracer_adv.cu``) over
  the WENO rate;
- given each kernel's bytes (every input read once, every output written once, as
  ``chip_smoke.py`` phase 9 counts them from the kernel's real operands), its byte
  bound over the measured stream rate.

Prints one line per number with the card's name and power limit, and as its last
line one JSON object. Runs on a card only; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

EXT = 724 * 1484       # points of the widened free-surface plane (halo 22)
N_SUB = 21             # SM05 weights of substeps = 30
NZ = 10
# interior cells of a base plane where the stencil kernels reconstruct (they write 0
# within 3 cells of the edge)
INNER = (690 - 6) * (1450 - 6)
# per call on the main paths: (upwind WENO-5 reconstructions, barotropic
# point-substeps). Momentum reconstructs q at the u and v points (2 a cell and
# layer); tracer advection needs each face once, one x face and one y face a cell
# (2 a cell and plane). The kernels' bytes are not kept here: chip_smoke.py counts
# them from the real operands.
MAIN_PATH = {
    "barotropic": (0, N_SUB * EXT),
    "momentum": (2 * INNER, 0),
    "momentum_layered": (2 * INNER * NZ, 0),
    "momentum_closures": (2 * INNER * NZ, 0),
    "tracer_adv": (2 * INNER, 0),
    "tracer_adv_layered": (2 * INNER * NZ, 0),            # the front's c
    "tracer_adv_kappa": (2 * INNER * 2 * NZ, 0),          # the gyre's T and S
}

BARO_TILE, BARO_ITER, BARO_TILES_PER_SM = (8, 128), 512, 12  # the substep probe's run


def baro_inputs(n_tiles, tile=BARO_TILE, dtype=None, device="cuda", seed=0):
    """The probe's inputs as ``roofline.py:baro_substep_sol`` makes them: a static
    pack of 1e-6·N(0,1) (so the iterate stays finite), a dynamic pack of N(0,1), and
    dτ = 1e-7."""
    import numpy as np
    import torch

    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    shape = (n_tiles, 5) + tuple(tile)
    spack = torch.as_tensor(1e-6 * rng.standard_normal(shape), dtype=dtype, device=device)
    dpack = torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=device)
    dtau = torch.tensor([1e-7], dtype=dtype, device=device)
    return spack, dpack, dtau


def baro_n_tiles(device="cuda"):
    """Tiles of the substep probe's run: ``BARO_TILES_PER_SM`` for every SM."""
    import torch

    return BARO_TILES_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def baro_sol_rate(n_iter=BARO_ITER, tile=BARO_TILE, n_tiles=None, dtype=None,
                  device="cuda", reps=3):
    """(point-substeps/s, ms per launch) of the substep probe over ``n_tiles``
    periodic tiles (``baro_n_tiles`` by default), ``n_iter`` substeps in one launch."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import time_ms

    if n_tiles is None:
        n_tiles = baro_n_tiles(device)
    spack, dpack, dtau = baro_inputs(n_tiles, tile, dtype, device)
    ms = time_ms(lambda: probes.baro_substep_sol(spack, dpack, dtau, n_iter), n=1,
                 reps=reps, warm=1, device=device)
    return n_tiles * tile[0] * tile[1] * n_iter / (ms * 1e-3), ms


STREAM_N = 64 * 2**20          # float32 elements of the stream probe (256 MB)
FMA_N, FMA_ITER = 8 * 2**20, 64  # elements and iterations of the FMA ceiling


def measure(device="cuda"):
    """The four ceilings on ``device``, with the ms of one launch of each kernel:
    {"stream_gbps", "stream_ms", "fma_tflops", "fma_ms", "weno_recon_per_s",
    "weno_ms", "baro_pts_per_s", "baro_ms"}."""
    from benchmarks.torch_weno_sol import weno_probe_rate
    from orthogonalsphericalshellgrids_tpu_torch.kernels.probes import FMA_FLOPS
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import (
        fma_ceiling, stream_probe_gbps)

    gbps = stream_probe_gbps(n=STREAM_N, device=device)
    tflops = fma_ceiling(n=FMA_N, n_iter=FMA_ITER, device=device)
    out = {"stream_gbps": gbps, "stream_ms": 8 * STREAM_N / (gbps * 1e9) * 1e3,
           "fma_tflops": tflops,
           "fma_ms": FMA_FLOPS * FMA_N * FMA_ITER / (tflops * 1e12) * 1e3}
    out["weno_recon_per_s"], out["weno_ms"] = weno_probe_rate(device=device)
    out["baro_pts_per_s"], out["baro_ms"] = baro_sol_rate(device=device)
    return out


def bounds(ceil, kernel_bytes=None):
    """{kernel: (byte bound ms or None, math bound ms or None)} from the measured
    ceilings: the bytes of ``kernel_bytes`` ({kernel: bytes}) over the stream rate;
    the reconstructions of ``MAIN_PATH`` over the WENO rate, or its point-substeps
    over the substep rate."""
    kernel_bytes = kernel_bytes or {}
    out = {}
    for name in sorted(set(MAIN_PATH) | set(kernel_bytes)):
        recon, pts = MAIN_PATH.get(name, (0, 0))
        t_b = (kernel_bytes[name] / (ceil["stream_gbps"] * 1e9) * 1e3
               if name in kernel_bytes else None)
        t_m = None
        if recon:
            t_m = recon / ceil["weno_recon_per_s"] * 1e3
        elif pts:
            t_m = pts / ceil["baro_pts_per_s"] * 1e3
        out[name] = (t_b, t_m)
    return out


def report(ceil, card, log=print, kernel_ms=None, kernel_bytes=None):
    """Print the ceilings and the derived bounds, one line each; ``kernel_bytes`` maps
    a kernel to its bytes and ``kernel_ms`` to its measured ms, printed beside its
    bounds."""
    from benchmarks.torch_weno_sol import WENO_ITER, WENO_ROWS, WENO_XE

    log(f"stream: {ceil['stream_gbps']:.2f} GB/s ({STREAM_N * 4 >> 20} MB each way, 20 "
        f"chained launches) [{card}]")
    log(f"FMA: {ceil['fma_tflops']:.4f} TFLOP/s f32 ({FMA_N >> 20}M elements x {FMA_ITER} "
        f"iterations of 264 flops) [{card}]")
    log(f"WENO-5 probe: {ceil['weno_recon_per_s'] / 1e9:.4f} G reconstructions/s "
        f"({ceil['weno_ms']:.4f} ms for {WENO_ROWS} x {WENO_XE} x {WENO_ITER}) [{card}]")
    log(f"barotropic substep probe: {ceil['baro_pts_per_s'] / 1e9:.4f} G point-substeps/s "
        f"({ceil['baro_ms']:.4f} ms for {BARO_ITER} substeps of {BARO_TILE} tiles) [{card}]")
    for name, (t_b, t_m) in bounds(ceil, kernel_bytes).items():
        parts = []
        if t_b is not None:
            parts.append(f"byte bound {t_b:.5f} ms")
        if t_m is not None:
            kind = "math" if MAIN_PATH[name][1] else "WENO"
            parts.append(f"{kind} bound {t_m:.5f} ms")
        line = ", ".join(parts)
        if kernel_ms and name in kernel_ms:
            t = kernel_ms[name]
            line += (f"; kernel {t:.4f} ms, {t / max(t_b or 0.0, t_m or 0.0):.2f}x its "
                     f"larger bound")
        log(f"measured bounds of {name}: {line} [{card}]")


def main():
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import smi_line

    if not torch.cuda.is_available():
        print("torch_roofline: no CUDA device available", file=sys.stderr)
        return 1
    card = smi_line()
    ceil = measure()
    report(ceil, card)
    print(json.dumps({"card": card, **ceil, "bounds": bounds(ceil)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
