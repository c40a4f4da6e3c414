#!/usr/bin/env python3
"""Measure the ``vs_baseline`` denominator of ``bench_torch.py`` and
``bench_layered_torch.py``: the same workload through the port's plain PyTorch path
on the host CPU.

Counterpart: ``benchmarks/cpu_reference_proxy.py`` (the JAX package's, through
XLA:CPU). The reference publishes no numbers and its own execution vehicle is the
CPU, so one host's CPU running the identical physics is the measured stand-in. Run
it on the host of the machine that holds the card, so that numerator and denominator
come from one machine: the 1/4-degree Bickley jet (1440 x 680, substeps 30, blocks of
10 steps at dt = 60 s) or, with ``layered=1``, the 1/4-degree x 10 gyre (blocks of 5
steps at dt = 40 s, as the JAX proxy), float32, on the CPU whatever the machine
holds (the denominator is a CPU by definition). One block to warm up, then the best
of 3 windows of ``blocks`` blocks. Prints one JSON line with the CPU's model name and
torch's thread count; paste ``cpu_points_per_s`` into the bench's
``MEASURED_CPU_HOST_POINTS_PER_S`` with the date, the CPU and the thread count.

Run from the repo root: ``python3 benchmarks/torch_cpu_reference_proxy.py [layered=1]
[nx=1440 ny=680 substeps=30 blocks=2 nz=10]``. Imports nothing of JAX.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(nx=1440, ny=680, substeps=30, blocks=2, layered=0, nz=10):
    import torch

    import bench_layered_torch
    import bench_torch
    from orthogonalsphericalshellgrids_tpu_torch.models import layered_multi_step, multi_step
    from orthogonalsphericalshellgrids_tpu_torch.utils.profiling import cpu_line

    if layered:
        model, state = bench_layered_torch.build(nx, ny, nz, substeps, device="cpu")
        stepper, block, dt = layered_multi_step, 5, bench_layered_torch.DT
    else:
        model, state = bench_torch.build(nx, ny, substeps, device="cpu")
        stepper, block, dt = multi_step, bench_torch.BLOCK, bench_torch.DT
        nz = 1
    s = stepper(model, state, dt, block)  # warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(blocks):
            s = stepper(model, s, dt, block)
        best = min(best, time.perf_counter() - t0)
    if not bool(torch.isfinite(s.u).all()):
        raise RuntimeError("the proxy produced non-finite fields")
    pts = nx * ny * nz * blocks * block / best
    out = {"cpu_points_per_s": round(pts, 1), "nx": nx, "ny": ny, "nz": nz,
           "layered": bool(layered), "elapsed_s": round(best, 3),
           "threads": torch.get_num_threads(), "cpu": cpu_line(),
           "date": time.strftime("%Y-%m-%d")}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    kw = {}
    for arg in sys.argv[1:]:
        k, v = arg.lstrip("-").split("=")
        kw[k] = int(v)
    main(**kw)
