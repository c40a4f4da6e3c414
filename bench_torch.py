#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port: the Bickley jet on the 1/4-degree (1440 x
680) tripolar grid on one CUDA card, BASELINE.md's primary metric
(grid-points/s/chip).

Counterpart: ``bench.py`` (the JAX package's), with its configuration
(``examples/bickley_jet_torch.py:build(1440, 680, substeps=30)``, float32, the grid,
scheme and step of ``perfbench/configs/bickley_jet_q.json``), its block of 10
``multi_step`` steps at dt = 60 s, and its metric string, unit and keys.

Prints ONE JSON line on stdout:
  {"metric": "...", "value": N, "unit": "grid-points/s/chip", "vs_baseline": N,
   "stream_probe_gbps": [...], "ms_per_step": t, "ms_per_step_host_ahead": t,
   "blocks": n, "device": "..."}

Timing as in ``bench_layered_torch.py``: ``warmup`` blocks, then 3 rounds of ``steps``
blocks between CUDA events; ``value`` and ``ms_per_step`` are the best round, every
round goes to stderr, and ``ms_per_step_host_ahead`` is the device's own time with the
host held ahead. The jet is host-bound on an H100 (its device work is shorter than
the host's enqueue of it), so ``value`` follows the host's speed; the two ms figures
side by side show by how much.

Then, on stderr: the layered gyre's line (``bench_layered_torch.run``) or
``layered-bench: FAILED: ...``, and the collective smoke, ``cuda-nccl-smoke: ok`` or
``cuda-nccl-smoke: FAILED: ...`` (``cpu-gloo-smoke`` with ``--device cpu``): a 1-rank
process group (``parallel.spawn``) runs the collectives that ``ProcessGroupExchange``
and ``utils/checkpoint.py``'s directories use, each checked for its values. Neither
failure touches the headline line, as in ``bench.py:121-163``.

vs_baseline: the same workload through the port's plain PyTorch path on the host CPU
of the machine that holds the card (``benchmarks/torch_cpu_reference_proxy.py``).

Run:  python3 bench_torch.py [--nx 1440 --ny 680 --substeps 30 --device cuda]
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench_layered_torch as layered_bench  # noqa: E402

# Measured CPU-host throughput of the IDENTICAL 1440 x 680 workload through the port's
# plain path: `python3 benchmarks/torch_cpu_reference_proxy.py` on the host of the
# machine with the H100, 2026-10-17: 8 threads, CPU "unknown" (/proc/cpuinfo's model
# name there), best of 3 windows of 2 blocks of 10 steps, 3869015.7 points/s.
MEASURED_CPU_HOST_POINTS_PER_S = 3.869e6

BLOCK = layered_bench.BLOCK  # steps per timed call (bench.py:49)
DT = 60.0  # s (bench.py:54)
METRIC = ("grid-points/s/chip (Bickley jet, 1/4deg tripolar, WENO-5 + split-explicit "
          "substeps=30)")  # bench.py:113, whatever the size, as there


def build(nx=1440, ny=680, substeps=30, device="cuda", dtype=None):
    """(model, state) of the benchmark's jet on ``device`` (float32 unless ``dtype``)."""
    import torch

    from examples.bickley_jet_torch import build as build_jet

    return build_jet(nx, ny, dtype=dtype or torch.float32, substeps=substeps,
                     device=device)


def block(model, state):
    """One timed call: ``BLOCK`` steps at ``DT``."""
    from orthogonalsphericalshellgrids_tpu_torch.models import multi_step

    return multi_step(model, state, DT, BLOCK)


def _collective_rank(rank, n):
    """One rank of ``collectives``: a send to the next rank and a receive from the one
    before in one ``batch_isend_irecv`` (``ProcessGroupExchange``'s call; with one rank
    a send to itself, the counterpart of the JAX bench's self-``ppermute``, which
    torch runs on NCCL inside the batch), all_gather, all_reduce and
    all_gather_object (``utils/checkpoint.py``'s directories) on the group's device,
    each checked; returns nothing."""
    import torch
    import torch.distributed as dist

    dev = f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "cpu"
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128) + rank
    if n > 1 or dist.get_backend() == "nccl":  # gloo has no pair to its own rank
        got = torch.empty_like(x)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % n),
                                            dist.P2POp(dist.irecv, got, (rank - 1) % n)]):
            work.wait()
        if not torch.equal(got, x - rank + (rank - 1) % n):
            raise RuntimeError("batch_isend_irecv mismatch")
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    total = x.clone()
    dist.all_reduce(total)
    base = x - rank
    want = [base + k for k in range(n)]
    if not all(torch.equal(p, w) for p, w in zip(parts, want)):
        raise RuntimeError("all_gather mismatch")
    if not torch.equal(total, sum(want)):
        raise RuntimeError("all_reduce mismatch")
    objs = [None] * n
    dist.all_gather_object(objs, {"rank": rank})
    if objs != [{"rank": k} for k in range(n)]:
        raise RuntimeError(f"all_gather_object gave {objs}")


def collectives(device):
    """The collective smoke: ``"ok"`` or ``"FAILED: ..."`` (see the module docstring).
    NCCL on a card, gloo on the CPU."""
    import torch

    from orthogonalsphericalshellgrids_tpu_torch.parallel import spawn

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    try:
        spawn(1, _collective_rank, backend, timeout=300.0)
        return "ok"
    except Exception as e:  # noqa: BLE001 — reported, never fatal for the headline
        return f"FAILED: {type(e).__name__}: {e}"


def main(nx=1440, ny=680, substeps=30, warmup=3, steps=30, probe=True, device="cuda",
         model_state=None, layered=None):
    """Run the headline benchmark, print its line on stdout and the layered line and
    the collective smoke on stderr. ``model_state`` = (model, state) steps that jet in
    place of a new build (its grid sets nx and ny); ``layered`` holds keyword arguments
    of ``bench_layered_torch.run`` (by default its defaults on ``device``). Returns
    (the headline dict, the layered dict or its failure, the collective smoke)."""
    import torch

    model, state = model_state or build(nx, ny, substeps, device)
    nx, ny = model.grid.Nx, model.grid.Ny
    best, ahead, probes, n_blocks, s = layered_bench.measure(
        block, model, state, warmup, steps, probe, device, "bench")
    layered_bench.finite(s, "bench")
    points_per_s = nx * ny / (best * 1e-3)
    headline = {
        "metric": METRIC,
        "value": round(points_per_s, 1),
        "unit": "grid-points/s/chip",
        "vs_baseline": round(points_per_s / MEASURED_CPU_HOST_POINTS_PER_S, 3),
        "stream_probe_gbps": probes,
        "ms_per_step": best,
        "ms_per_step_host_ahead": ahead,
        "blocks": n_blocks,
        "device": layered_bench.device_line(device),
    }
    del s

    # the layered engine's line (stderr: stdout carries exactly one JSON line)
    try:
        lay = layered_bench.run(**{"device": device, "probe": probe, **(layered or {})})
        print(json.dumps(lay), file=sys.stderr, flush=True)
    except Exception as e:  # noqa: BLE001 — loud, but never corrupts the headline
        lay = f"FAILED: {type(e).__name__}: {e}"
        print(f"layered-bench: {lay}", file=sys.stderr, flush=True)

    print(json.dumps(headline), flush=True)

    smoke = collectives(device)
    name = "cuda-nccl-smoke" if torch.device(device).type == "cuda" else "cpu-gloo-smoke"
    print(f"{name}: {smoke}", file=sys.stderr, flush=True)
    return headline, lay, smoke


if __name__ == "__main__":
    args = layered_bench.parser(__doc__.splitlines()[0], nx=1440, ny=680, substeps=30,
                                warmup=3, steps=30).parse_args()
    main(**vars(args))
