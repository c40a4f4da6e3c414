#!/usr/bin/env python3
"""The WENO-5 op-mix rate of one CUDA card, for the PyTorch port's stencil kernels.

    python3 benchmarks/torch_weno_sol.py

Counterpart of ``benchmarks/weno_sol.py``. It prints, each with the card's name and
power limit:

- the FMA ceiling (``utils/profiling.py:fma_ceiling``, TFLOP/s);
- the probe's rate (``kernels/probes.py:weno_probe``): ``WENO_ITER`` chained upwind
  WENO-5 reconstructions of every cell of ``WENO_ROWS`` x-periodic rows of 1536, the
  rows held in shared memory, in one launch timed with CUDA events, the result
  checked finite; in G reconstructions/s and TFLOP/s at the 70 flops of
  ``ANALYTIC``;
- the plain version's rate (``probes.weno_probe_plain``, one PyTorch launch per
  operation, the left-biased body of ``weno_sol.py:xla_fused_rate``), the
  counterpart of the JAX package's XLA-fused rate.

The TPU's issue-slot model of ``weno_sol.py:72-125`` is the TPU's and is not carried
over; its flop column is. The last line is one JSON object with the numbers. Runs on
a card only; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# (name, flops) of one upwind WENO-5 reconstruction, read from ops/advection.py:
# _weno5_left top to bottom (weno_sol.py:86-118 without its VPU issue slots); the
# stencil taps and the upwind select cost no flops
ANALYTIC = [("q0", 6), ("q1", 5), ("q2", 5), ("b0", 12), ("b1", 9), ("b2", 12),
            ("tau = |b0 - b2|", 1), ("a0", 4), ("a1", 4), ("a2", 4), ("s = a0+a1+a2", 2),
            ("num = a0 q0 + a1 q1 + a2 q2", 5), ("num / s", 1)]
FLOPS_PER_RECONSTRUCTION = sum(f for _, f in ANALYTIC)
# the probe's run: rows of the TPU probe's width, 16 on each of 132 SMs (the TPU's 96
# rows were a VMEM limit). The chained map grows the iterate, which turns NaN in
# float32 within 1024 iterations (tests/test_torch_probes.py), and NaN takes the
# division's slow path; so the run stops at 256 and checks its result finite (the
# TPU probe's 2048 and 6144 iterations time NaN)
WENO_ROWS, WENO_XE, WENO_ITER = 2112, 1536, 256


def probe_input(rows=WENO_ROWS, xe=WENO_XE, dtype=None, device="cuda", seed=0):
    """The TPU probe's input (``weno_sol.py:170-171``): N(0,1) from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((rows, xe)),
                           dtype=dtype or torch.float32, device=device)


def weno_probe_rate(n_iter=WENO_ITER, rows=WENO_ROWS, xe=WENO_XE, upwind=True, dtype=None,
                    device="cuda", reps=3):
    """(reconstructions/s, ms per launch) of the probe kernel: ``rows`` x ``xe``
    cells, ``n_iter`` iterations in one launch, the median of ``reps``."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import time_ms

    x = probe_input(rows, xe, dtype, device)
    if not bool(probes.weno_probe(x, n_iter, upwind).isfinite().all()):
        raise ValueError(f"weno_probe_rate: the iterate is not finite after {n_iter} "
                         "iterations; a rate on non-finite data is no ceiling")
    ms = time_ms(lambda: probes.weno_probe(x, n_iter, upwind), n=1, reps=reps, warm=1,
                 device=device)
    return rows * xe * n_iter / (ms * 1e-3), ms


def plain_rate(n_iter=20, rows=1024, xe=WENO_XE, upwind=False, dtype=None, device="cuda",
               reps=3):
    """(reconstructions/s, ms per call) of the plain version, the counterpart of
    ``weno_sol.py:xla_fused_rate`` (left-biased, 1024 rows)."""
    from orthogonalsphericalshellgrids_tpu_torch.kernels import probes
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import time_ms

    x = probe_input(rows, xe, dtype, device)
    ms = time_ms(lambda: probes.weno_probe_plain(x, n_iter, upwind), n=1, reps=reps,
                 warm=1, device=device)
    return rows * xe * n_iter / (ms * 1e-3), ms


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_weno_sol: no CUDA device available", file=sys.stderr)
        return 1
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import fma_ceiling, smi_line

    card = smi_line()
    for name, f in ANALYTIC:
        print(f"  {name:30s} flops={f:3d}")
    print(f"  TOTAL flops={FLOPS_PER_RECONSTRUCTION} per upwind reconstruction")
    fma = fma_ceiling()
    print(f"FMA ceiling: {fma:.4f} TFLOP/s f32 [{card}]", flush=True)
    rate, ms = weno_probe_rate()
    print(f"WENO-5 probe: {rate / 1e9:.4f} G reconstructions/s ({ms:.4f} ms for "
          f"{WENO_ROWS} x {WENO_XE} x {WENO_ITER}), {rate * FLOPS_PER_RECONSTRUCTION / 1e12:.4f}"
          f" TFLOP/s = {rate * FLOPS_PER_RECONSTRUCTION / 1e12 / fma:.1%} of the FMA "
          f"ceiling [{card}]", flush=True)
    prate, pms = plain_rate()
    print(f"plain version: {prate / 1e9:.4f} G reconstructions/s ({pms:.4f} ms for "
          f"1024 x 1536 x 20), {prate / rate:.1%} of the probe [{card}]", flush=True)
    print(json.dumps({"card": card, "fma_tflops": fma, "weno_recon_per_s": rate,
                      "weno_ms": ms, "plain_recon_per_s": prate, "plain_ms": pms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
